"""The port's captured prefill, against the JAX package on the CPU.

In ``decode_mode="fused"`` a request's prefill is one step over static
buffers (``ServingEngine._prefill_fn``), a CUDA graph per (prompt bucket,
variant) on a card, so it takes its length, slot and shared prefix as
0-d device tensors and reads no host value. Here that function runs
uncaptured, and through a CPU stand-in of ``jit.graphs.StepGraphs`` for
the graph route's keys and counters; it must give the reference's logits,
pages and tokens, and the eager prefill's, admission after admission into
one bucket.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.inference.serving import ServingEngine as JEngine
from paddle_tpu.models.gpt import GPT as JGPT
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.inference.sampling import SamplingParams
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.utils.convert import load_numpy_params

_CFG = dict(vocab_size=256, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=2, dropout=0.0, attn_dropout=0.0)
_KW = dict(max_batch=2, max_len=32, page_size=8)
_SAMPLED = dict(temperature=0.9, top_k=20, top_p=0.9)


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


class _CPUGraphs:
    """``StepGraphs``'s interface on the CPU: a key's first use counts a
    capture, later uses a replay, and each runs the step over the same
    static buffers, as a replayed graph reads them."""

    def __init__(self):
        self.graphs, self.replays = {}, {}
        self.captures = self.pool_bytes = 0

    def run(self, key, fn):
        if key in self.graphs:
            self.replays[key] += 1
        else:
            self.graphs[key] = (None, {}, None)
            self.replays[key] = 0
            self.captures += 1
        return fn()


# (bucket, length, start): page and bucket edges, shared prefixes
_APPEND_CASES = [(8, 8, 0), (8, 5, 0), (8, 1, 0), (16, 16, 4), (16, 9, 3),
                 (16, 13, 12), (16, 8, 8), (16, 4, 9)]


@pytest.mark.parametrize("bucket,length,start", _APPEND_CASES)
def test_prefill_append_tensor_form_matches_the_reference(bucket, length,
                                                          start):
    """All pages equal the reference's, the null page included: positions
    outside [start, length) land on page 0 at offset 0 in both."""
    rng = np.random.default_rng(bucket * 100 + length * 10 + start)
    pool = rng.normal(size=(7, 4, 2, 8)).astype(np.float32)
    row = np.array([5, 2, 6, 3], np.int32)
    k_seq = rng.normal(size=(bucket, 2, 8)).astype(np.float32)
    v_seq = rng.normal(size=(bucket, 2, 8)).astype(np.float32)
    jk, jv = jpa.prefill_append(jnp.asarray(pool), jnp.asarray(pool),
                                jnp.asarray(k_seq), jnp.asarray(v_seq),
                                jnp.asarray(row), jnp.int32(length),
                                start=jnp.int32(start))
    tk, tv = torch.from_numpy(pool.copy()), torch.from_numpy(pool.copy())
    pa.prefill_append(tk, tv, torch.from_numpy(k_seq),
                      torch.from_numpy(v_seq), torch.from_numpy(row),
                      torch.tensor(length), start=torch.tensor(start))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the int form writes the same live positions and leaves page 0 alone
    ik, iv = torch.from_numpy(pool.copy()), torch.from_numpy(pool.copy())
    pa.prefill_append(ik, iv, torch.from_numpy(k_seq),
                      torch.from_numpy(v_seq), torch.from_numpy(row),
                      length, start=start)
    np.testing.assert_array_equal(ik.numpy()[1:], tk.numpy()[1:])
    np.testing.assert_array_equal(ik.numpy()[0], pool[0])


def _cache_pair(jm, tm, max_batch=2, max_len=32, page_size=8):
    jc = jm.init_cache(max_batch, max_len, page_size=page_size)
    tc = tm.init_cache(max_batch, max_len, page_size=page_size)
    row = np.arange(1, 1 + max_batch * tc.pages_per_seq, dtype=np.int32
                    ).reshape(max_batch, -1)[::-1].copy()
    jc.block_tables = jnp.asarray(row)
    tc.block_tables.copy_(torch.from_numpy(row))
    return jc, tc


def test_forward_prefill_tensor_form_matches_int_form_and_reference(models):
    """Two admissions into one bucket (16) with other lengths, slots and
    shared prefixes: the tensor form's logits equal the int form's bit
    for bit and the reference's to 1e-5; the pages, block tables and
    context lengths are the reference's (the null page the int form
    leaves alone aside)."""
    jm, tm = models
    jc, ic = _cache_pair(jm, tm)
    _, tc = _cache_pair(jm, tm)
    rng = np.random.default_rng(0)
    for slot, n, start in ((1, 13, 0), (0, 9, 8), (1, 16, 3)):
        ids = np.zeros((1, 16), np.int64)
        ids[0, :n] = rng.integers(1, 256, n)
        jl, jc = jm.forward_prefill(paddle.to_tensor(ids.astype(np.int32)),
                                    jc, slot, n, write_start=start)
        il, _ = tm.forward_prefill(torch.from_numpy(ids), ic, slot, n,
                                   write_start=start)
        tl, _ = tm.forward_prefill(torch.from_numpy(ids), tc,
                                   torch.tensor(slot), torch.tensor(n),
                                   write_start=torch.tensor(start))
        assert torch.equal(tl, il)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl.data),
                                   rtol=1e-5, atol=1e-5)
        for li in range(len(tc.k_pages)):
            for got, ref in ((tc.k_pages[li], jc.k_pages[li]),
                             (tc.v_pages[li], jc.v_pages[li])):
                np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                           rtol=1e-5, atol=1e-5)
            assert torch.equal(tc.k_pages[li][1:], ic.k_pages[li][1:])
        np.testing.assert_array_equal(tc.context_lens.numpy(),
                                      np.asarray(jc.context_lens))
        assert torch.equal(tc.context_lens, ic.context_lens)


@pytest.mark.parametrize("variant", ["greedy", "sampled"])
def test_static_prefill_matches_the_eager_prefill(models, variant):
    """Admissions through the static function (the graph route, with the
    CPU stand-in counting captures and replays) against the eager
    prefill: the same first tokens and the same pages, block tables and
    context lengths, over admissions into one bucket at other lengths,
    slots and shared prefixes. The keys are ("prefill", bucket,
    variant); the first use captures, each later one replays."""
    _, tm = models
    sp = SamplingParams(**_SAMPLED) if variant == "sampled" else None
    kw = dict(_KW, max_batch=4)
    fused = ServingEngine(tm, device="cpu", **kw)
    fused._step_graphs = _CPUGraphs()
    eager = ServingEngine(tm, decode_mode="eager", device="cpu", **kw)
    rng = np.random.default_rng(7)
    a = rng.integers(1, 256, 12).tolist()
    # slots 0-3, lengths 12 / 9 / 15 (its first page forked from the
    # first prompt's: write_start 8) / 14, all in the 16 bucket
    prompts = [a, rng.integers(1, 256, 9).tolist(), a[:8] + [5, 6, 7] * 2
               + [9], rng.integers(1, 256, 14).tolist()]
    firsts = []
    for eng in (fused, eager):
        toks = []
        for i, p in enumerate(prompts):
            kw = {} if sp is None else {"sampling": SamplingParams(
                seed=i, **_SAMPLED)}
            r = eng.submit(p, max_new_tokens=3, **kw)
            eng._admit()
            assert r.slot == i
            toks.append(r.generated[0])
        firsts.append(toks)
        cache = eng.cache
        eng.snapshot = ([t.clone() for t in cache.k_pages + cache.v_pages],
                        cache.block_tables.clone(), cache.context_lens.clone())
        eng.run_until_idle()
    assert firsts[0] == firsts[1]
    assert fused.stats["shared_admissions"] == eager.stats[
        "shared_admissions"] > 0
    pools, bt, ctx = fused.snapshot
    ref_pools, ref_bt, ref_ctx = eager.snapshot
    assert torch.equal(bt, ref_bt) and torch.equal(ctx, ref_ctx)
    for got, ref in zip(pools, ref_pools):
        assert torch.equal(got[1:], ref[1:])
    key = ("prefill", 16, variant)
    assert fused.graph_replays[key] == len(prompts) - 1
    assert fused.stats["prefill_graph_replays"] == len(prompts) - 1
    assert fused.stats["graph_captures"] == len(fused._graphs)
    assert {k for k in fused._graphs if k[0] == "prefill"} == {key}


def test_prefill_reads_no_host_value(models, monkeypatch):
    """The static prefill reads no device value on the host (what a
    captured graph would bake in): every Tensor-to-Python conversion
    raises while it runs, and a second admission into its bucket still
    gives the eager tokens."""
    _, tm = models
    fused = ServingEngine(tm, device="cpu", **_KW)
    eager = ServingEngine(tm, decode_mode="eager", device="cpu", **_KW)
    real = fused._prefill_fn

    def guarded(buf, sampled):
        def refuse(*a, **k):
            raise AssertionError("the prefill read a tensor on the host")
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "numpy", "__int__", "__float__",
                         "__bool__"):
                m.setattr(torch.Tensor, name, refuse)
            real(buf, sampled)
    fused._prefill_fn = guarded
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 256, n).tolist() for n in (11, 6, 16)]
    outs = []
    for eng in (fused, eager):
        reqs = [eng.submit(p, max_new_tokens=4, sampling=SamplingParams(
            seed=i, **_SAMPLED) if i == 1 else None)
            for i, p in enumerate(prompts)]
        eng.run_until_idle()
        outs.append([r.result(timeout=5) for r in reqs])
    assert outs[0] == outs[1]


def test_greedy_tokens_equal_the_reference_with_the_static_prefill(models):
    """The fused engine (static prefill and decode) on the reference
    engine's workload, with a shared prefix and a pool small enough to
    preempt: the reference's greedy tokens."""
    jm, tm = models
    rng = np.random.default_rng(9)
    a = rng.integers(1, 256, 10).tolist()
    work = [(a, 14), (a + [3, 4], 12),
            (rng.integers(1, 256, 15).tolist(), 8),
            (rng.integers(1, 256, 4).tolist(), 7)]
    outs = []
    for eng in (JEngine(jm, name="j-pf", num_pages=5, **_KW),
                ServingEngine(tm, name="t-pf", num_pages=5, device="cpu",
                              **_KW)):
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in work]
        eng.run_until_idle()
        outs.append([r.result(timeout=5) for r in reqs])
        assert eng.stats["preemptions"] > 0
    assert outs[0] == outs[1]
