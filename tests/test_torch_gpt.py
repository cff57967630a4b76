"""The port's GPT (paddle_tpu_torch/models/gpt.py) against the JAX
package's, on the CPU, with the JAX model's weights carried across.

Both run fp32 on the CPU; the JAX side takes its XLA references for the
Pallas kernels (as its own CPU tests do), the port its plain versions.
Logits agree to fp32 atol 1e-4 (sums in another order through two layers
and a 1024-way tied head); greedy tokens must be identical. Float32
matrix products are full fp32: ``torch.backends.cuda.matmul.allow_tf32``
stays False (checked below), so the same holds where these run on a card.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPT as JGPT
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.utils.convert import load_numpy_params

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = JGPT(JConfig.tiny())
    jm.eval()
    params = {k: np.asarray(p.data) for k, p in jm.named_parameters()}
    tm = GPT(GPTConfig.tiny(), device="cpu")
    load_numpy_params(tm, params)
    tm.eval()
    return jm, tm, params


def _ids(seed, B, L, vocab=1024):
    return np.random.default_rng(seed).integers(1, vocab, (B, L)).astype(
        np.int32)


def _j(x):
    return paddle.to_tensor(np.asarray(x, np.int32))


def _t(x):
    return torch.from_numpy(np.asarray(x, np.int64))


def test_fp32_products_are_not_tf32():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_parameter_names_and_layouts_match(pair):
    jm, tm, params = pair
    mine = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    assert mine == {k: v.shape for k, v in params.items()}
    assert mine["blocks.0.attn.qkv.weight"] == (64, 192)  # [in, out]
    assert set(tm.state_dict()) == set(params)


def test_dense_forward_logits(pair):
    jm, tm, _ = pair
    ids = _ids(0, 2, 24)
    want = np.asarray(jm(_j(ids)).data)
    with torch.no_grad():
        got = tm(_t(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_prefill_and_teacher_forced_decode_logits(pair):
    """Prefill a 13-token prompt in a 16 bucket (padding attends to junk
    and must not matter), then 6 decode steps fed the same tokens."""
    jm, tm, _ = pair
    prompt = _ids(1, 1, 13)[0]
    feed = _ids(2, 1, 6)[0]
    bucket = np.zeros((1, 16), np.int32)
    bucket[0, :13] = prompt
    jc = jm.init_cache(2, 32, page_size=4)
    jc.block_tables = jc.block_tables.at[1].set(
        np.arange(1, 9, dtype=np.int32))
    tc = tm.init_cache(2, 32, page_size=4)
    tc.block_tables[1] = torch.arange(1, 9, dtype=torch.int32)
    jl, jc = jm.forward_prefill(_j(bucket), jc, 1, 13)
    with torch.no_grad():
        tl, _ = tm.forward_prefill(_t(bucket), tc, 1, 13)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl.data), atol=ATOL,
                               rtol=0)
    assert tc.context_lens.tolist() == [0, 13]
    active = np.array([False, True])
    for tok in feed:
        toks = np.array([0, tok], np.int32)
        jl, jc = jm.forward_decode(_j(toks), jc, active=active)
        with torch.no_grad():
            tl, _ = tm.forward_decode(_t(toks), tc,
                                      active=torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy()[1], np.asarray(jl.data)[1],
                                   atol=ATOL, rtol=0)
    assert tc.context_lens.tolist() == np.asarray(jc.context_lens).tolist()
    np.testing.assert_allclose(tc.k_pages[0].numpy()[1:],
                               np.asarray(jc.k_pages[0])[1:], atol=ATOL)


def test_lane_mode_with_sentinel_lanes(pair):
    """Lane mode: lanes map to slots through slot_map; the padding lane
    (slot == max_batch) is clamped for its reads and dropped from the
    context-length update, as in the reference."""
    jm, tm, _ = pair
    jc = jm.init_cache(3, 16, page_size=4)
    tc = tm.init_cache(3, 16, page_size=4)
    bt = np.arange(1, 13, dtype=np.int32).reshape(3, 4)
    jc.block_tables = paddle.to_tensor(bt).data
    tc.block_tables.copy_(torch.from_numpy(bt))
    for slot, n in ((0, 5), (2, 3)):
        p = np.zeros((1, 8), np.int32)
        p[0, :n] = _ids(slot, 1, n)[0]
        _, jc = jm.forward_prefill(_j(p), jc, slot, n)
        with torch.no_grad():
            tm.forward_prefill(_t(p), tc, slot, n)
    slot_map = np.array([2, 0, 3, 3], np.int32)
    active = slot_map < 3
    toks = np.array([7, 9, 0, 0], np.int32)
    jl, jc = jm.forward_decode(_j(toks), jc, active, slot_map=slot_map)
    with torch.no_grad():
        tl, _ = tm.forward_decode(_t(toks), tc, torch.from_numpy(active),
                                  slot_map=torch.from_numpy(slot_map))
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl.data)[:2],
                               atol=ATOL, rtol=0)
    assert tc.context_lens.tolist() == [6, 0, 4]
    assert tc.context_lens.tolist() == np.asarray(jc.context_lens).tolist()


@pytest.mark.parametrize("page_size", [4, 8])
def test_generate_paged_tokens_identical(pair, page_size):
    jm, tm, _ = pair
    ids = _ids(3, 2, 11)
    want = np.asarray(jm.generate_paged(_j(ids), 7,
                                        page_size=page_size).data)
    with torch.no_grad():
        got = tm.generate_paged(_t(ids), 7, page_size=page_size).numpy()
        dense = tm.generate_dense(_t(ids), 7).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(dense, want)


def test_generate_zero_tokens_returns_input(pair):
    _, tm, _ = pair
    ids = _t(_ids(4, 1, 5))
    assert tm.generate_paged(ids, 0) is ids


def test_load_numpy_params_checks(pair):
    _, _, params = pair
    m = GPT(GPTConfig.tiny(), device="cpu")
    with pytest.raises(KeyError):
        load_numpy_params(m, {k: v for k, v in params.items()
                              if k != "wte.weight"})
    bad = dict(params)
    bad["wpe.weight"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        load_numpy_params(m, bad)
    load_numpy_params(m, {"wte.weight": params["wte.weight"]}, strict=False)
    np.testing.assert_array_equal(m.wte.weight.detach().numpy(),
                                  params["wte.weight"])


def test_bf16_model_runs_and_tracks_fp32(pair):
    """A bf16 copy of the weights runs the same path (kernels take bf16)
    and its logits stay near the fp32 ones."""
    _, tm, params = pair
    m16 = GPT(GPTConfig.tiny(), device="cpu", dtype="bfloat16")
    load_numpy_params(m16, params)
    ids = _t(_ids(5, 1, 9))
    with torch.no_grad():
        a = tm(ids)
        b = m16(ids)
    assert b.dtype == torch.bfloat16
    assert float((a - b.float()).abs().max()) < 0.1


def test_seeded_init_is_reproducible():
    a = GPT(GPTConfig.tiny(), device="cpu",
            generator=torch.Generator().manual_seed(7))
    b = GPT(GPTConfig.tiny(), device="cpu",
            generator=torch.Generator().manual_seed(7))
    for (ka, pa_), (kb, pb) in zip(a.named_parameters(),
                                   b.named_parameters()):
        assert ka == kb and torch.equal(pa_, pb)
    assert torch.equal(a.blocks[0].ln1.weight, torch.ones(64))


def test_init_cache_rejects_max_len_past_positions(pair):
    _, tm, _ = pair
    with pytest.raises(ValueError):
        tm.init_cache(1, 129)
    c = tm.init_cache(2, 20, page_size=8)
    assert (c.num_pages, c.pages_per_seq, c.max_batch) == (7, 3, 2)
    assert c.k_pages[0].shape == (7, 8, 4, 16)
