"""The port's serving engine options and its graph-safe sampler, against the
JAX package's engine on the CPU with the same weights.

Both of the port's decode modes ("fused": the step over static lane
buffers, a CUDA graph on a card and a plain call here; "eager": op by op)
must give the reference engine's greedy tokens and finish reasons under
each constructor option the reference takes (an engine-wide ``eos_id``,
custom ``prefill_buckets``, ``share_prefix=False``, ``mem_budget_bytes``).
Sampled tokens are not JAX's bits, so they are held to the port's own
contract: the same in both modes, a device ``fold_seed`` equal to the host
one, draws inside the top-k/top-p set, one lane's draw a function of its
own (seed, step), and frequencies within a chi-square bound of the
softmax.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import ServingEngine as JEngine
from paddle_tpu.models.gpt import GPT as JGPT
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu_torch.inference import sampling
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.utils.convert import load_numpy_params

_CFG = dict(vocab_size=256, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=2, dropout=0.0, attn_dropout=0.0)
_KW = dict(max_batch=2, max_len=32, page_size=8)

#: chi-square critical value at 7 degrees of freedom, p = 0.001
_CHI2_7DOF_P001 = 24.32


@pytest.fixture(scope="module")
def models():
    paddle.seed(3)
    jm = JGPT(JConfig(**_CFG))
    jm.eval()
    tm = GPT(GPTConfig(**_CFG), device="cpu")
    load_numpy_params(tm, {k: np.asarray(p.data)
                           for k, p in jm.named_parameters()})
    tm.eval()
    return jm, tm


def _work():
    """An exact duplicate (a shared tail page), a page-aligned prefix and
    its continuation, and one other prompt."""
    rng = np.random.default_rng(4)
    a = rng.integers(1, 256, 8).tolist()
    b = rng.integers(1, 256, 5).tolist()
    c = rng.integers(1, 256, 11).tolist()
    return [(b, 6), (b, 6), (a, 8), (a + [7, 9], 5), (c, 7)]


def _run(engine, work, **submit_kw):
    reqs = [engine.submit(p, max_new_tokens=n, **submit_kw)
            for p, n in work]
    engine.run_until_idle()
    return [(r.result(timeout=5), r.finish_reason) for r in reqs]


def _three(jm, tm, name, **kw):
    """The reference's engine and the port's in both modes, built alike."""
    return (JEngine(jm, name=f"j-{name}", **kw),
            ServingEngine(tm, name=f"f-{name}", device="cpu", **kw),
            ServingEngine(tm, name=f"e-{name}", decode_mode="eager",
                          device="cpu", **kw))


def test_engine_wide_eos(models):
    jm, tm = models
    plain = _run(ServingEngine(tm, device="cpu", **_KW), _work())
    eos = plain[2][0][3]  # a token request 2 reaches mid-way
    je, fe, ee = _three(jm, tm, "eos", eos_id=eos, **_KW)
    ref = _run(je, _work())
    assert ref[2] == (plain[2][0][:plain[2][0].index(eos) + 1], "eos")
    assert _run(fe, _work()) == ref and _run(ee, _work()) == ref
    # a request's own eos_id wins over the engine's
    r = fe.submit(_work()[2][0], max_new_tokens=8, eos_id=-1)
    fe.run_until_idle()
    assert (r.result(), r.finish_reason) == (plain[2][0], "length")
    assert fe.make_request([1, 2], 2).eos_id == eos


def test_prefill_buckets(models):
    jm, tm = models
    je, fe, ee = _three(jm, tm, "buckets", prefill_buckets=[12, 4, 4, 12],
                        **_KW)
    assert fe.prefill_buckets == je.prefill_buckets == [4, 12, 32]
    ref = _run(je, _work())
    assert _run(fe, _work()) == ref and _run(ee, _work()) == ref


def test_share_prefix_off(models):
    jm, tm = models
    je, fe, ee = _three(jm, tm, "noshare", share_prefix=False, **_KW)
    ref = _run(je, _work())
    for te in (fe, ee):
        assert _run(te, _work()) == ref
        assert te.stats["shared_admissions"] == 0 == je.stats[
            "shared_admissions"]
        assert te.stats["cow_copies"] == 0 and len(te._prefix) == 0
        assert te.allocator.outstanding() == {}


def test_mem_budget_caps_the_pool(models):
    jm, tm = models
    full = ServingEngine(tm, device="cpu", **_KW)
    per_page = full.pool_bytes() // full.cache.num_pages
    je, fe, ee = _three(jm, tm, "budget", mem_budget_bytes=4 * per_page + 1,
                        **_KW)
    for te in (fe, ee):
        assert te.cache.num_pages == je.cache.num_pages == 4
        assert te.pool_bytes() == je.pool_bytes() == 4 * per_page
        assert te.status()["budget_capped_pages"] == (
            full.cache.num_pages, 4) == je.status()["budget_capped_pages"]
    work = _work()[:2] + _work()[4:]  # the duplicates grow into a dry pool
    ref = _run(je, work)
    assert _run(fe, work) == ref and _run(ee, work) == ref
    assert fe.stats["preemptions"] == je.stats["preemptions"] > 0


def test_status_carries_the_reference_keys(models):
    jm, tm = models
    je = JEngine(jm, name="j-status", priority=3, **_KW)
    te = ServingEngine(tm, name="t-status", priority=3, device="cpu", **_KW)
    st, ref = te.status(), je.status()
    assert set(st) == set(ref) | {"graphs", "device"}
    assert st["graphs"] == 0 and st["device"] == "cpu"
    for key in ("decode_mode", "priority", "share_prefix", "tp_degree",
                "tp_axis", "mem_budget_bytes", "decode_buckets",
                "prefill_buckets", "num_pages"):
        assert st[key] == ref[key], key


def test_constructor_errors(models):
    jm, tm = models
    with pytest.raises(ValueError) as ref:
        JEngine(jm, decode_mode="jit", **_KW)
    with pytest.raises(ValueError) as got:
        ServingEngine(tm, decode_mode="jit", device="cpu", **_KW)
    assert str(got.value) == str(ref.value)
    with pytest.raises(TypeError):
        ServingEngine(tm, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        ServingEngine(tm, mesh=object(), device="cpu", **_KW)


def test_sampled_tokens_equal_between_modes(models):
    """Sampled and greedy requests mixed in one batch, with and without
    preemption: the fused step and the eager one draw the same tokens."""
    _, tm = models
    work = _work()
    outs = []
    for mode in ("fused", "eager"):
        for num_pages in (0, 6):
            te = ServingEngine(tm, decode_mode=mode, num_pages=num_pages,
                               device="cpu", **_KW)
            reqs = [te.submit(p, max_new_tokens=n, sampling=(
                sampling.SamplingParams(temperature=0.8, top_k=40,
                                        top_p=0.95, seed=i)
                if i % 2 == 0 else None)) for i, (p, n) in enumerate(work)]
            te.run_until_idle()
            outs.append([r.result() for r in reqs])
    assert outs[0] == outs[1] == outs[2] == outs[3]


def test_fold_seed_device_twin():
    rng = np.random.default_rng(0)
    edges = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.int64)
    seeds = np.concatenate([rng.integers(0, 2 ** 32, 10000 - 25),
                            np.repeat(edges, 5)])
    steps = np.concatenate([rng.integers(0, 2 ** 32, 10000 - 25),
                            np.tile(edges, 5)])
    got = sampling.fold_seed_tensor(torch.from_numpy(seeds),
                                    torch.from_numpy(steps)).tolist()
    assert got == [sampling.fold_seed(int(a), int(b))
                   for a, b in zip(seeds, steps)]


def test_draws_stay_in_the_truncated_set():
    rng = np.random.default_rng(5)
    B, V = 64, 50
    logits = torch.from_numpy(rng.normal(size=(B, V)).astype(np.float32))
    top_k = torch.from_numpy(rng.integers(0, 8, B))
    top_p = torch.from_numpy(rng.uniform(0.2, 1.0, B).astype(np.float32))
    temp = torch.full((B,), 0.7)
    kept = torch.isfinite(sampling._truncate(logits / 0.7, top_k, top_p))
    for step in range(20):
        tok = sampling.sample_logits(logits, temp, top_k, top_p,
                                     torch.arange(B), torch.full((B,), step))
        assert kept[torch.arange(B), tok.long()].all()


def test_a_lanes_draw_is_its_own():
    rng = np.random.default_rng(6)
    logits = torch.from_numpy(rng.normal(size=(8, 40)).astype(np.float32))
    args = ([0.9] * 8, [0] * 8, [1.0] * 8, list(range(10, 18)), [3] * 8)
    full = sampling.sample_logits(logits, *args)
    for i in range(8):
        solo = sampling.sample_logits(logits[i:i + 1], [0.9], [0], [1.0],
                                      [10 + i], [3])
        assert int(solo[0]) == int(full[i])
    # other lanes' seeds, logits and policy do not move lane 0's draw
    other = logits.clone()
    other[1:] = torch.from_numpy(rng.normal(size=(7, 40)).astype(np.float32))
    moved = sampling.sample_logits(other, [0.9] + [0.5] * 7, [0] + [3] * 7,
                                   [1.0] * 8, [10] + [99] * 7, [3] + [0] * 7)
    assert int(moved[0]) == int(full[0])
    # the greedy variant and the sampling variant agree on greedy lanes
    mixed = sampling.sample_logits(logits, [0.0, 0.9] * 4, [0] * 8, [1.0] * 8,
                                   list(range(8)), [0] * 8, sampled=True)
    assert torch.equal(mixed[::2], logits[::2].argmax(-1).to(torch.int32))


def test_draw_frequencies_follow_the_softmax():
    """4,000 fixed seeds at V 8: the counts' chi-square distance from the
    softmax stays below the 0.1 % critical value of 7 degrees of freedom,
    for the seed stream and for one request's step stream."""
    logits = torch.tensor([[1.0, 0.5, 0.2, -1.0, 2.0, 0.0, 0.3, -0.5]])
    n = 4000
    p = torch.softmax(logits[0], 0).numpy().astype(np.float64)
    for seeds, steps in ((list(range(n)), [0] * n), ([7] * n, list(range(n)))):
        tok = sampling.sample_logits(logits.repeat(n, 1), [1.0] * n, [0] * n,
                                     [1.0] * n, seeds, steps)
        counts = np.bincount(tok.numpy(), minlength=8)
        chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
        assert chi2 < _CHI2_7DOF_P001, (chi2, counts)
