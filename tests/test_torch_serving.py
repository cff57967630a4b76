"""The port's serving core (paddle_tpu_torch/inference) against the JAX
package's, on the CPU with the same weights.

Greedy tokens must be identical request by request, with shared-prefix
admission (page-aligned chains and exact duplicates, which fork the tail
page copy-on-write) and with preemption under a small page pool; the
engines must also agree on how often they preempted, shared and copied,
and leave no page outstanding. Sampled tokens cannot match (the port's
counter-based draw is not JAX's fold_in), so the sampler is held to its
own contract: pure in (seed, n), and exact argmax for greedy lanes.
"""
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import sampling as jsampling
from paddle_tpu.inference.serving import ServingEngine as JEngine
from paddle_tpu.models.gpt import GPT as JGPT
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu_torch.inference import sampling
from paddle_tpu_torch.inference.serving import (PageAllocator, Request,
                                                ServingEngine, _PrefixCache,
                                                _pow2_buckets)
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.utils.convert import load_numpy_params

_CFG = dict(vocab_size=512, max_position_embeddings=128, hidden_size=32,
            num_layers=2, num_heads=2, dropout=0.0, attn_dropout=0.0)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JGPT(JConfig(**_CFG))
    jm.eval()
    tm = GPT(GPTConfig(**_CFG), device="cpu")
    load_numpy_params(tm, {k: np.asarray(p.data)
                           for k, p in jm.named_parameters()})
    tm.eval()
    return jm, tm


def _workload():
    """(prompt, max_new) pairs: an exact duplicate (shares its partial
    tail page, forked on the first decode write), a page-aligned prefix
    and its continuation (shares two full pages), and two others."""
    rng = np.random.default_rng(0)
    a = rng.integers(1, 512, 16).tolist()
    b = rng.integers(1, 512, 13).tolist()
    c = rng.integers(1, 512, 20).tolist()
    d = rng.integers(1, 512, 9).tolist()
    return [(b, 6), (b, 6), (a, 20), (a + [5, 6, 7], 8), (c, 12), (d, 12)]


def _serve(engine, work):
    reqs = [engine.submit(p, max_new_tokens=n) for p, n in work]
    engine.run_until_idle()
    return [r.result(timeout=5) for r in reqs]


@pytest.mark.parametrize("num_pages", [9, 14])
def test_engine_tokens_match_reference(models, num_pages):
    """num_pages=9 (8 usable) forces preemption; 14 does not."""
    jm, tm = models
    work = _workload()
    kw = dict(max_batch=3, max_len=48, page_size=8, num_pages=num_pages)
    je = JEngine(jm, name=f"j{num_pages}", **kw)
    te = ServingEngine(tm, device="cpu", **kw)
    assert _serve(te, work) == _serve(je, work)
    for key in ("preemptions", "shared_admissions", "cow_copies",
                "prefix_hit_tokens", "prefills", "completed"):
        assert te.stats[key] == je.stats[key], key
    assert te.stats["shared_admissions"] == 2 and te.stats["cow_copies"] == 1
    assert (te.stats["preemptions"] > 0) == (num_pages == 9)
    assert te.allocator.outstanding() == {}
    assert te.status()["free_pages"] == num_pages - 1
    assert not te.cache.context_lens.any()
    assert not te.cache.block_tables.any()


def test_engine_matches_generate_paged_and_eos(models):
    _, tm = models
    prompt = np.random.default_rng(1).integers(1, 512, 10).tolist()
    with torch.no_grad():
        ref = tm.generate_paged(torch.tensor([prompt]), 6,
                                page_size=8)[0, 10:].tolist()
    te = ServingEngine(tm, max_batch=2, max_len=32, page_size=8,
                       device="cpu")
    assert te.generate(prompt, max_new_tokens=6)["tokens"] == ref
    j = next(i for i in range(1, 6) if ref[i] not in ref[:i])
    r = te.submit(prompt, max_new_tokens=6, eos_id=ref[j])
    te.run_until_idle()
    assert r.result() == ref[:j + 1] and r.finish_reason == "eos"


def test_background_thread_and_close(models):
    _, tm = models
    te = ServingEngine(tm, max_batch=2, max_len=32, page_size=8,
                       device="cpu")
    te.start(poll_s=0.001)
    try:
        reqs = [te.submit([3, 4, 5], max_new_tokens=4) for _ in range(3)]
        outs = [r.result(timeout=30) for r in reqs]
        assert all(len(o) == 4 for o in outs)
    finally:
        te.close()
    assert te._thread is None
    with pytest.raises(RuntimeError):
        te.submit([1], max_new_tokens=1)


def test_close_fails_queued_requests(models):
    _, tm = models
    te = ServingEngine(tm, max_batch=1, max_len=32, page_size=8,
                       device="cpu")
    r = te.submit([1, 2], max_new_tokens=3)
    te.close()
    with pytest.raises(RuntimeError, match="engine closed"):
        r.result(timeout=1)


@pytest.mark.parametrize("prompt,max_new,kw", [
    ([], 2, {}), ([1] * 30, 5, {}), ([512], 1, {}), ([1] * 8, 20,
                                                      {"num_pages": 3})])
def test_submit_validation(models, prompt, max_new, kw):
    _, tm = models
    te = ServingEngine(tm, max_batch=1, max_len=32, page_size=8,
                       device="cpu", **kw)
    with pytest.raises(ValueError):
        te.submit(prompt, max_new_tokens=max_new)


def test_engine_rejects_model_on_another_device(models):
    _, tm = models
    with pytest.raises((ValueError, RuntimeError)):
        ServingEngine(tm, device="cuda")


# ------------------------------ host-side parts ------------------------------


def test_page_allocator_refcounts():
    released = []
    a = PageAllocator(5, on_release=released.append)
    got = a.alloc(3)
    assert sorted(got) == [1, 2, 3] and a.alloc(2) is None
    assert a.free_pages == 1
    a.fork(got[:2] + [0])
    assert a.shared_page_count == 2 and a.is_shared(got[0])
    a.free(got)
    assert released == [got[2]] and a.refcount(got[0]) == 1
    a.free(got[:2] + [0])
    assert a.outstanding() == {} and a.free_pages == 4
    assert 0 not in a._free


def test_prefix_cache_chain_and_exact_tail():
    pc = _PrefixCache(4)
    pc.register([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [11, 12, 13])
    assert pc.lookup([1, 2, 3, 4, 5, 6, 7, 8, 0]) == ([11, 12], 8)
    assert pc.lookup([1, 2, 3, 4, 5, 6, 7, 8, 9, 10]) == ([11, 12, 13], 10)
    assert pc.lookup([1, 2, 3, 4, 5, 6, 7, 8, 9]) == ([11, 12], 8)
    pc.drop_page(12)
    assert pc.lookup([1, 2, 3, 4, 5, 6, 7, 8]) == ([11], 4)


def test_pow2_buckets_and_request_latency_fields():
    assert _pow2_buckets(16, 1024) == [16, 32, 64, 128, 256, 512, 1024]
    assert _pow2_buckets(1, 6) == [1, 2, 4, 6]
    r = Request([1, 2], 4)
    assert r.ttft_s is None and r.tpot_s is None
    assert r.seed == r.rid & 0x7FFFFFFF


def test_truncate_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(5, 40)).astype(np.float32)
    logits[1, :4] = logits[1, 4]  # ties stay together
    top_k = np.array([0, 3, 1, 40, 7], np.int32)
    top_p = np.array([1.0, 0.5, 1.0, 0.2, 0.9], np.float32)
    want = np.asarray(jsampling._truncate(jnp.asarray(logits),
                                          jnp.asarray(top_k),
                                          jnp.asarray(top_p)))
    got = sampling._truncate(torch.from_numpy(logits),
                             torch.from_numpy(top_k),
                             torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[~np.isinf(got)],
                                  want[~np.isinf(want)])


def test_sampler_determinism_contract():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
    temp = [0.0, 1.0, 0.7, 1.3]
    args = (temp, [0, 0, 5, 0], [1.0, 0.9, 1.0, 1.0], [3, 3, 8, 9],
            [0, 4, 2, 7])
    a = sampling.sample_logits(logits, *args)
    b = sampling.sample_logits(logits, *args)
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert int(a[0]) == int(logits[0].argmax())
    # lane 1's draw depends only on its own (seed, step), not the batch
    solo = sampling.sample_logits(logits[1:2], [1.0], [0], [0.9], [3], [4])
    assert int(solo[0]) == int(a[1])
    assert int(a[2]) in logits[2].topk(5).indices.tolist()
    assert sampling.fold_seed(3, 4) == sampling.fold_seed(3, 4)
    assert len({sampling.fold_seed(3, n) for n in range(100)}) == 100
    greedy = sampling.sample_logits(logits, [0.0] * 4, [0] * 4, [1.0] * 4,
                                    [0] * 4, [0] * 4)
    assert torch.equal(greedy, logits.argmax(-1).to(torch.int32))


def test_sampled_requests_survive_preemption(models):
    """Sampled tokens are pure in (seed, n): the same seeded requests give
    the same tokens whether or not a small pool preempts them."""
    _, tm = models
    sp = sampling.SamplingParams(temperature=0.9, top_k=20, seed=5)
    work = [(p, n) for p, n in _workload()[2:]]
    outs = []
    for num_pages in (0, 9):
        te = ServingEngine(tm, max_batch=3, max_len=48, page_size=8,
                           num_pages=num_pages, device="cpu")
        reqs = [te.submit(p, max_new_tokens=n, sampling=sp)
                for p, n in work]
        te.run_until_idle()
        outs.append([r.result() for r in reqs])
        if num_pages:
            assert te.stats["preemptions"] > 0
    assert outs[0] == outs[1]


def test_sampling_params_validation():
    for bad in (dict(temperature=-1), dict(top_k=-1), dict(top_p=0.0)):
        with pytest.raises(ValueError):
            sampling.SamplingParams(**bad)
    assert sampling.SamplingParams().greedy


def test_submit_is_thread_safe(models):
    _, tm = models
    te = ServingEngine(tm, max_batch=2, max_len=32, page_size=8,
                       device="cpu")
    errs = []

    def worker():
        try:
            for _ in range(20):
                te.submit([1, 2, 3], max_new_tokens=1)
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errs.append(e)

    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not errs and not any(t.is_alive() for t in ts)
    assert te.queue_depth() == 160
    te.close()
