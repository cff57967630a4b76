"""The flash kernels' bool-mask operand, ``F.dropout`` / ``nn.Dropout`` and
``nn.Linear`` with the reference's signatures, and Transformer-base
trained on padded batches, against the JAX package on the CPU.

The masked plain versions (what a CPU tensor takes, and what the card's
kernels are held to) go against the reference's Pallas kernels run in the
interpreter with ``mask_is_bool=True``: the tiled forward, the one-pass
and split backwards (64-row blocks) and the small path. Masks are
[B, 1, 1, Lk] key padding, [B, 1, Lq, Lk] causal-and-padding, a shared
[1, 1, Lq, Lk] and a full [B, H, Lq, Lk], with whole rows masked, Lq != Lk,
tails off the 64-row block and the mask with causal. A row with no
visible key gives 0 in both packages; its lse is -inf in the port and the
floor (about -1e30) in the reference, so lse is compared on the other
rows.

Dropout is random in both packages and their streams differ, so it is
held to the reference by the dropped fraction, the keep mask's broadcast
shape under ``axis``, and both modes' scaling, not bit for bit.

Transformer-base is built by a thin wrapper, the same in both packages
(as ``chip_smoke.py`` builds it for the card): a shared embedding scaled
by sqrt(d_model), fixed sinusoidal positions, ``nn.Transformer``, the
output projection tied to the embedding, and cross-entropy with
ignore_index -100 on padded target positions; bool masks (True = attend).

Tolerances: the masked kernels fp32 atol 2e-5 forward and 1e-5 backward,
as ``tests/test_torch_kernels.py``; the slice's fp32 loss, gradients and
one Adam + NoamDecay step atol 1e-4 and its O2 bf16 loss atol 2e-2, as
``tests/test_torch_bert.py``.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.incubate import nn as jinc
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import matmul as jmatmul
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch import jit, nn, optimizer
from paddle_tpu_torch.incubate import nn as inc
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.utils.convert import load_numpy_params

FWD_ATOL = 2e-5
BWD_ATOL = 1e-5
MODEL_ATOL = 1e-4
O2_LOSS_ATOL = 2e-2
CPU = dict(device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(getattr(x, "data", x), np.float32)


# ------------------------------- C4: dropout --------------------------------


def _drop_both(shape, p, seed, **kw):
    """F.dropout of ones in both packages: (reference, port) as numpy."""
    x = np.ones(shape, np.float32)
    paddle.seed(seed)
    want = _np(JF.dropout(paddle.to_tensor(x), p, **kw))
    got = _np(F.dropout(torch.from_numpy(x), p, generator=torch.Generator(
    ).manual_seed(seed), **kw))
    return want, got


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_drops_the_fraction_and_scales_as_reference(p, mode):
    """A third positional argument is ``axis`` (None here), so
    F.dropout(x, p, None) drops in training, as the reference does; kept
    values are 1 / (1 - p) upscaled, 1 downscaled."""
    want, got = _drop_both((64, 64), p, 0, mode=mode)
    keep_value = 1.0 / (1.0 - p) if mode == "upscale_in_train" else 1.0
    for y in (want, got):
        assert abs(float((y == 0).mean()) - p) < 0.04
        np.testing.assert_allclose(np.unique(y[y != 0]), [keep_value],
                                   rtol=1e-6)
    y = F.dropout(torch.ones(64, 64), p, None)  # positional axis = None
    assert abs(float((y == 0).float().mean()) - p) < 0.04


@pytest.mark.parametrize("axis", [0, 1, [0, 2], (1, 2)])
def test_dropout_axis_broadcasts_the_keep_mask_as_reference(axis):
    """With ``axis`` the keep mask is drawn over those dims and broadcast
    over the rest: the zero pattern is constant along every other dim, in
    both packages."""
    axes = [axis] if isinstance(axis, int) else list(axis)
    for y in _drop_both((6, 5, 4), 0.5, 1, axis=axis):
        zero = y == 0
        for d in range(3):
            if d not in axes:
                first = np.take(zero, [0], axis=d)
                assert (zero == first).all(), (axis, d)
        assert 0 < zero.mean() < 1


@pytest.mark.parametrize("mode,want", [("upscale_in_train", 1.0),
                                       ("downscale_in_infer", 0.7)])
def test_dropout_eval_mode_matches_reference(mode, want):
    """training=False: the identity upscaled, x * (1 - p) downscaled, in
    the functional (training as the fourth positional argument) and in
    nn.Dropout(p, axis, mode) after eval()."""
    x = np.full((3, 4), 2.0, np.float32)
    ref = _np(JF.dropout(paddle.to_tensor(x), 0.3, None, False, mode))
    got = F.dropout(torch.from_numpy(x), 0.3, None, False, mode)
    np.testing.assert_allclose(_np(got), ref, rtol=1e-6)
    np.testing.assert_allclose(ref, 2.0 * want, rtol=1e-6)
    jl, tl = jnn.Dropout(0.3, None, mode), nn.Dropout(0.3, None, mode)
    jl.eval()
    tl.eval()
    np.testing.assert_allclose(_np(tl(torch.from_numpy(x))),
                               _np(jl(paddle.to_tensor(x))), rtol=1e-6)


def test_dropout_layer_takes_axis_and_mode():
    layer = nn.Dropout(0.5, axis=1, mode="downscale_in_infer")
    y = layer(torch.ones(4, 6, 3))
    assert ((y == 0) == (y[:1, :, :1] == 0)).all()
    assert set(np.unique(_np(y))) <= {0.0, 1.0}
    with pytest.raises(ValueError):
        F.dropout(torch.ones(2), 0.5, mode="scale")


# -------------------------------- C5: Linear --------------------------------


@pytest.mark.parametrize("args,has_bias", [((None, False), False),
                                           ((False,), True),
                                           ((None, None), True),
                                           ((), True)])
def test_linear_attribute_slots_match_reference(args, has_bias):
    """The third argument is weight_attr: Linear(4, 8, None, False) has no
    bias, Linear(4, 8, False) keeps the default weight and a bias, in both
    packages."""
    paddle.seed(0)
    jl = jnn.Linear(4, 8, *args)
    tl = nn.Linear(4, 8, *args, **CPU)
    assert (jl.bias is not None) is has_bias
    assert (tl.bias is not None) is has_bias
    assert tuple(tl.weight.shape) == (4, 8)


@pytest.mark.parametrize("kw", [dict(weight_attr="w"), dict(bias_attr=True),
                                dict(bias_attr="b")])
def test_linear_other_attributes_raise(kw):
    with pytest.raises(NotImplementedError):
        nn.Linear(4, 8, **kw, **CPU)


def test_transformer_bias_attr_false_matches_reference():
    """bias_attr=False reaches every Linear of the transformer layers by
    keyword (no bias in the projections or the FFN), in both packages;
    the reference's weights load strictly and the outputs agree."""
    rng = np.random.default_rng(0)
    kw = dict(d_model=16, nhead=2, num_encoder_layers=1,
              num_decoder_layers=1, dim_feedforward=32, dropout=0.0,
              bias_attr=False)
    paddle.seed(0)
    jt = jnn.Transformer(**kw)
    tt = nn.Transformer(**kw, **CPU)
    names = {k for k, _ in tt.named_parameters()}
    assert names == {k for k, _ in jt.named_parameters()}
    assert not any(n.endswith("proj.bias") or n.endswith("linear1.bias")
                   for n in names)
    load_numpy_params(tt, {k: np.asarray(p.data)
                           for k, p in jt.named_parameters()})
    src = rng.standard_normal((2, 5, 16)).astype(np.float32)
    tgt = rng.standard_normal((2, 4, 16)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tt(torch.from_numpy(src), torch.from_numpy(tgt))),
        _np(jt(paddle.to_tensor(src), paddle.to_tensor(tgt))),
        atol=MODEL_ATOL, rtol=0)


# ------------------------- the masked flash kernels --------------------------


def _mask(rng, kind, B, H, Lq, Lk, causal=False):
    """A bool mask (numpy) of `kind`, with whole rows masked where the
    kind has rows of its own."""
    if kind in ("pad", "tril_pad"):
        lens = rng.integers(Lk // 2, Lk + 1, B)
        m = (np.arange(Lk)[None, :] < lens[:, None])[:, None, None, :]
        if kind == "tril_pad":
            m = m & np.tril(np.ones((Lq, Lk), bool), k=Lk - Lq)
        return m
    shape = {"shared": (1, 1, Lq, Lk), "full": (B, H, Lq, Lk),
             "rows": (B, 1, Lq, Lk)}[kind]
    m = rng.random(shape) > 0.3
    m[..., 3, :] = False  # a row with no visible key
    if causal and Lq <= Lk:
        m[..., Lq - 1, :] = False
    return m


def _inputs(seed, B, Lq, Lk, H, D, kind, causal):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Lq, H, D), (B, Lk, H, D), (B, Lk, H, D),
                      (B, Lq, H, D))]
    m = _mask(rng, kind, B, H, Lq, Lk, causal)
    return ([jnp.asarray(a) for a in arrs] + [jnp.asarray(m)],
            [torch.from_numpy(a) for a in arrs] + [torch.from_numpy(m)])


def _seen(m, causal, B, H, Lq, Lk):
    """[B, H, Lq] numpy bool: rows that see a key."""
    keep = np.broadcast_to(m, (B, H, Lq, Lk))
    if causal:
        keep = keep & np.tril(np.ones((Lq, Lk), bool), k=Lk - Lq)
    return keep.any(-1)


MASK_CASES = [  # (B, Lq, Lk, H, D, kind, causal)
    (2, 100, 100, 2, 32, "pad", False),
    (2, 100, 130, 2, 32, "pad", True),
    (2, 112, 112, 2, 16, "tril_pad", False),
    (2, 70, 130, 2, 16, "shared", False),
    (2, 100, 100, 2, 16, "full", True),
    (2, 130, 100, 2, 16, "rows", False),
]
MASK_IDS = [f"{c[5]}-{c[1]}x{c[2]}{'-causal' if c[6] else ''}"
            for c in MASK_CASES]


@pytest.mark.parametrize("case", MASK_CASES, ids=MASK_IDS)
def test_masked_forward_plain_matches_tiled_pallas(case):
    B, Lq, Lk, H, D, kind, causal = case
    (jq, jk, jv, _, jm), (tq, tk, tv, _, tm) = _inputs(1, *case)
    scale = 1.0 / math.sqrt(D)
    jout, jlse = jfa._fa_fwd_pallas(jq, jk, jv, jm, causal, scale,
                                    mask_is_bool=True, interpret=True,
                                    blocks=(64, 64))
    kernels.reset_stats()
    out, lse = fa.flash_attention_fwd(tq, tk, tv, causal, scale, mask=tm)
    assert kernels.all_stats()["flash_attention_masked"] == {
        "kernel": 0, "plain": 1}
    seen = _seen(_np(tm) > 0, causal, B, H, Lq, Lk)
    assert bool((~seen).any()) is (kind not in ("pad", "tril_pad"))
    np.testing.assert_allclose(_np(out), _np(jout), atol=FWD_ATOL, rtol=0)
    assert (_np(out).transpose(0, 2, 1, 3)[~seen] == 0).all()
    np.testing.assert_allclose(_np(lse)[seen], _np(jlse)[seen],
                               atol=FWD_ATOL, rtol=0)
    assert np.isneginf(_np(lse)[~seen]).all()


@pytest.mark.parametrize("kind,causal", [("pad", False), ("tril_pad", False),
                                         ("full", True), ("shared", True)])
def test_masked_plain_matches_small_path_pallas(kind, causal):
    """The small path (Lq == Lk <= 512, all heads a program): forward and
    backward."""
    case = (2, 96, 96, 3, 16, kind, causal)
    B, L, _, H, D = case[:5]
    (jq, jk, jv, jdo, jm), (tq, tk, tv, tdo, tm) = _inputs(2, *case)
    scale = 0.25
    jout, jlse = jfa._fa_small_fwd_pallas(jq, jk, jv, jm, causal, scale,
                                          mask_is_bool=True, interpret=True)
    want = jfa._fa_small_bwd_pallas(jq, jk, jv, jout, jlse, jdo, jm, causal,
                                    scale, mask_is_bool=True, interpret=True)
    out, lse = fa.flash_attention_fwd(tq, tk, tv, causal, scale, mask=tm)
    got = fa.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal, scale,
                                 mask=tm)
    seen = _seen(_np(tm) > 0, causal, B, H, L, L)
    np.testing.assert_allclose(_np(out), _np(jout), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(_np(lse)[seen], _np(jlse)[seen],
                               atol=FWD_ATOL, rtol=0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=BWD_ATOL, rtol=0)


@pytest.mark.parametrize("case", MASK_CASES, ids=MASK_IDS)
def test_masked_one_pass_plain_matches_fused_pallas(case):
    """The one-pass backward: dq, dk, dv; dq exactly 0 on a row with no
    visible key."""
    B, Lq, Lk, H, D, kind, causal = case
    (jq, jk, jv, jdo, jm), (tq, tk, tv, tdo, tm) = _inputs(3, *case)
    scale = 1.0 / math.sqrt(D)
    jout, jlse = jfa._fa_fwd_pallas(jq, jk, jv, jm, causal, scale,
                                    mask_is_bool=True, interpret=True,
                                    blocks=(64, 64))
    want = jfa._fa_bwd_fused_pallas(jq, jk, jv, jout, jlse, jdo, jm, causal,
                                    scale, mask_is_bool=True, interpret=True,
                                    blocks=(64, 64))
    out, lse = fa.flash_attention_fwd(tq, tk, tv, causal, scale, mask=tm)
    kernels.reset_stats()
    got = fa.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal, scale,
                                 mask=tm)
    assert kernels.all_stats()["flash_attention_bwd_masked"]["plain"] == 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=BWD_ATOL, rtol=0)
    seen = _seen(_np(tm) > 0, causal, B, H, Lq, Lk)
    assert (_np(got[0]).transpose(0, 2, 1, 3)[~seen] == 0).all()


@pytest.mark.parametrize("case", MASK_CASES[::2], ids=MASK_IDS[::2])
def test_masked_split_plain_matches_split_pallas(case):
    """The split pair's dq and dk/dv plain versions against the
    reference's two-kernel backward (``_fa_bwd_pallas``)."""
    B, Lq, Lk, H, D, kind, causal = case
    (jq, jk, jv, jdo, jm), (tq, tk, tv, tdo, tm) = _inputs(4, *case)
    scale = 1.0 / math.sqrt(D)
    jout, jlse = jfa._fa_fwd_pallas(jq, jk, jv, jm, causal, scale,
                                    mask_is_bool=True, interpret=True,
                                    blocks=(64, 64))
    want = jfa._fa_bwd_pallas(jq, jk, jv, jout, jlse, jdo, jm, causal, scale,
                              mask_is_bool=True, interpret=True,
                              blocks=(64, 64))
    out, lse = fa.flash_attention_fwd(tq, tk, tv, causal, scale, mask=tm)
    delta = fa.attention_delta(out, tdo)
    kernels.reset_stats()
    got = (fa.flash_attention_bwd_dq(tq, tk, tv, lse, delta, tdo, causal,
                                     scale, mask=tm),
           *fa.flash_attention_bwd_dkv(tq, tk, tv, lse, delta, tdo, causal,
                                       scale, mask=tm))
    stats = kernels.all_stats()
    assert stats["flash_attention_bwd_dq_masked"]["plain"] == 1
    assert stats["flash_attention_bwd_dkv_masked"]["plain"] == 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=BWD_ATOL, rtol=0)


def test_masked_gate_routes_a_long_sequence_to_the_split_pair(monkeypatch):
    """Past the one-pass gate (monkeypatched low) a masked backward runs
    the split pair's masked plain versions, and agrees with the one-pass
    plain version."""
    case = MASK_CASES[1]
    _, (tq, tk, tv, tdo, tm) = _inputs(5, *case)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=tm,
                                         is_causal=True)
    want = torch.autograd.grad(out, leaves, tdo)
    monkeypatch.setattr(fa, "_FUSED_BWD_DQ_BYTES", 1)
    kernels.reset_stats()
    out = F.scaled_dot_product_attention(*leaves, attn_mask=tm,
                                         is_causal=True)
    got = torch.autograd.grad(out, leaves, tdo)
    stats = kernels.all_stats()
    assert stats["flash_attention_bwd_dq_masked"]["plain"] == 1
    assert stats["flash_attention_bwd_masked"]["plain"] == 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=BWD_ATOL, rtol=0)


@pytest.mark.parametrize("shape,takes", [
    ((2, 1, 1, 9), True), ((2, 3, 5, 9), True), ((1, 1, 5, 9), True),
    ((1, 3, 1, 1), True), ((2, 2, 5, 9), False), ((2, 5, 9), False),
    ((5, 9), False), ((2, 1, 4, 9), False)])
def test_mask_gate_takes_4d_bool_masks_that_broadcast(shape, takes):
    """The reference's `_pallas_eligible` rule (l.1240-1251) against
    q [2, 5, 3, 8], k [2, 9, 3, 8]: each of the mask's four dims 1 or
    full; a float mask never."""
    q, k = torch.zeros(2, 5, 3, 8), torch.zeros(2, 9, 3, 8)
    m = torch.ones(shape, dtype=torch.bool)
    assert fa.mask_takes(q, k, m) is takes
    assert fa.kernel_takes(q, k, k, m) is takes
    assert not fa.mask_takes(q, k, m.float())
    assert fa.mask_takes(q, k, None)


def test_masked_attention_gradient_of_the_function_matches_composition():
    """Through F.scaled_dot_product_attention, a taken bool mask runs the
    FlashAttentionFunction (no composition) and gives the composition's
    output and gradients; the mask gets no gradient."""
    _, (tq, tk, tv, tdo, tm) = _inputs(6, *MASK_CASES[4])
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    kernels.reset_stats()
    out = F.scaled_dot_product_attention(*leaves, attn_mask=tm,
                                         is_causal=True)
    assert out.grad_fn._forward_cls is fa.FlashAttentionFunction
    got = torch.autograd.grad(out, leaves, tdo)
    assert kernels.composed_stats()["flash_attention"] == 0
    want_out = fa.attention_composition(*leaves, tm, True)
    want = torch.autograd.grad(want_out, leaves, tdo)
    np.testing.assert_allclose(_np(out), _np(want_out), atol=FWD_ATOL,
                               rtol=0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=BWD_ATOL, rtol=0)


@pytest.mark.parametrize("pre", [False, True])
def test_fused_attention_bool_mask_takes_the_kernels(pre):
    """incubate.nn.FusedMultiHeadAttention with a [B, H, L, L] bool mask
    (rows masked whole): routed as the reference's fused op routes it
    (its l.55: to flash_attention), so to the masked plain versions here;
    output and input gradient against the reference."""
    rng = np.random.default_rng(8)
    paddle.seed(8)
    E, L = 32, 12
    kw = dict(dropout_rate=0.0, attn_dropout_rate=0.0, normalize_before=pre)
    jm = jinc.FusedMultiHeadAttention(E, 4, **kw)
    tm = inc.FusedMultiHeadAttention(E, 4, **kw, **CPU)
    load_numpy_params(tm, {k: np.asarray(p.data)
                           for k, p in jm.named_parameters()})
    x = rng.standard_normal((2, L, E)).astype(np.float32)
    keep = _mask(rng, "full", 2, 4, L, L)
    tx = torch.from_numpy(x).requires_grad_(True)
    jx = paddle.to_tensor(x, stop_gradient=False)
    kernels.reset_stats()
    tout = tm(tx, attn_mask=torch.from_numpy(keep))
    jout = jm(jx, attn_mask=paddle.to_tensor(keep))
    assert kernels.all_stats()["flash_attention_masked"]["plain"] == 1
    assert kernels.composed_stats()["flash_attention"] == 0
    np.testing.assert_allclose(_np(tout), _np(jout), atol=MODEL_ATOL, rtol=0)
    tout.sum().backward()
    jout.sum().backward()
    np.testing.assert_allclose(_np(tx.grad), _np(jx.grad), atol=MODEL_ATOL,
                               rtol=0)


# ------------------- the slice: Transformer-base, padded batches -------------


def _sinusoid(L, d):
    """Vaswani et al.'s fixed positions: sin on even dims, cos on odd."""
    pos = np.arange(L)[:, None]
    ang = pos / np.power(10000.0, 2 * np.arange(d // 2)[None, :] / d)
    table = np.zeros((L, d), np.float32)
    table[:, 0::2] = np.sin(ang)
    table[:, 1::2] = np.cos(ang)
    return table


class _JTransformerBase(jnn.Layer):
    def __init__(self, vocab, d_model, nhead, layers, ffn, max_len,
                 dropout=0.0):
        super().__init__()
        self.d_model = d_model
        self.embedding = jnn.Embedding(vocab, d_model)
        self.transformer = jnn.Transformer(d_model, nhead, layers, layers,
                                           ffn, dropout, attn_dropout=0.0)
        self.dropout = jnn.Dropout(dropout)
        self._position = _sinusoid(max_len, d_model)

    def _embed(self, ids):
        x = self.embedding(ids) * math.sqrt(self.d_model)
        pos = paddle.to_tensor(self._position[:ids.shape[1]])
        return self.dropout(x + pos.astype(x.dtype))

    def forward(self, src, tgt, src_mask, tgt_mask, memory_mask):
        h = self.transformer(self._embed(src), self._embed(tgt), src_mask,
                             tgt_mask, memory_mask)
        return jmatmul(h, self.embedding.weight, transpose_y=True)


class _TransformerBase(nn.Layer):
    def __init__(self, vocab, d_model, nhead, layers, ffn, max_len,
                 dropout=0.0, device=None):
        super().__init__(device)
        self.d_model = d_model
        self.embedding = nn.Embedding(vocab, d_model, device=device)
        self.transformer = nn.Transformer(d_model, nhead, layers, layers,
                                          ffn, dropout, attn_dropout=0.0,
                                          device=device)
        self.dropout = nn.Dropout(dropout)
        self._position = torch.from_numpy(_sinusoid(max_len, d_model)).to(
            self._device)
        self.name_parameters()

    def _embed(self, ids):
        x = self.embedding(ids) * math.sqrt(self.d_model)
        return self.dropout(x + self._position[:ids.shape[1]].to(x.dtype))

    def forward(self, src, tgt, src_mask, tgt_mask, memory_mask):
        h = self.transformer(self._embed(src), self._embed(tgt), src_mask,
                             tgt_mask, memory_mask)
        return torch.matmul(h, self.embedding.weight.t())


TINY = dict(vocab=512, d_model=64, nhead=4, layers=2, ffn=128, max_len=24)
B, LS, LT = 2, 24, 20


def _padded_batch(seed):
    """(src, tgt_in, src_mask, tgt_mask, memory_mask, labels) as numpy:
    rows of random lengths (half to full), pad id 0, a BOS of 1 before
    the shifted target, labels -100 past each target's length."""
    rng = np.random.default_rng(seed)
    V = TINY["vocab"]
    src_len = np.array([LS, rng.integers(LS // 2, LS)])
    tgt_len = np.array([rng.integers(LT // 2, LT), LT])
    src = rng.integers(2, V, (B, LS))
    tgt = rng.integers(2, V, (B, LT))
    src[np.arange(LS)[None, :] >= src_len[:, None]] = 0
    tgt_in = np.concatenate([np.ones((B, 1), np.int64), tgt[:, :-1]], 1)
    past = np.arange(LT)[None, :] >= tgt_len[:, None]
    tgt_in[past] = 0
    labels = np.where(past, -100, tgt)
    src_keys = np.arange(LS)[None, :] < src_len[:, None]
    tgt_keys = np.arange(LT)[None, :] < tgt_len[:, None]
    src_mask = src_keys[:, None, None, :]
    tgt_mask = np.tril(np.ones((LT, LT), bool)) & tgt_keys[:, None, None, :]
    return (src.astype(np.int32), tgt_in.astype(np.int32), src_mask,
            tgt_mask, src_mask.copy(), labels.astype(np.int32))


def _jbatch(arrs):
    return tuple(paddle.to_tensor(a) for a in arrs)


def _tbatch(arrs):
    return tuple(torch.from_numpy(a).long() if a.dtype == np.int32
                 else torch.from_numpy(a) for a in arrs)


def _pair():
    paddle.seed(7)
    jm = _JTransformerBase(**TINY)
    tm = _TransformerBase(**TINY, **CPU)
    load_numpy_params(tm, {k: np.asarray(p.data)
                           for k, p in jm.named_parameters()})
    return jm, tm


def _steps(jm, tm, amp):
    """TrainStep with Adam(0.9, 0.98, 1e-9) over NoamDecay(d_model,
    warmup 4000) in both packages (the reference's fused_opt off, as the
    port's update is element for element the per-parameter loop)."""
    d = TINY["d_model"]
    jsched = jopt.lr.NoamDecay(d_model=d, warmup_steps=4000)
    tsched = optimizer.lr.NoamDecay(d_model=d, warmup_steps=4000)
    jst = JTrainStep(jm, JF.cross_entropy, jopt.Adam(
        learning_rate=jsched, beta1=0.9, beta2=0.98, epsilon=1e-9,
        parameters=jm.parameters()),
        amp_dtype=jnp.bfloat16 if amp else None, fused_opt=False)
    tst = jit.TrainStep(tm, F.cross_entropy, optimizer.Adam(
        learning_rate=tsched, beta1=0.9, beta2=0.98, epsilon=1e-9,
        parameters=tm.parameters()),
        amp_dtype=torch.bfloat16 if amp else None)
    return jst, tst, jsched, tsched


def test_transformer_base_padded_forward_and_masks_match_reference():
    """The wrapper's logits on a padded batch with bool masks: every
    attention (2 encoder self, 2 decoder self, 2 cross) takes the masked
    plain versions, none composes; the loss ignores padded targets."""
    jm, tm = _pair()
    arrs = _padded_batch(0)
    kernels.reset_stats()
    got = tm(*_tbatch(arrs)[:-1])
    want = jm(*_jbatch(arrs)[:-1])
    np.testing.assert_allclose(_np(got), _np(want), atol=MODEL_ATOL, rtol=0)
    stats = kernels.all_stats()
    assert stats["flash_attention_masked"] == {"kernel": 0, "plain": 6}
    assert stats["flash_attention"] == {"kernel": 0, "plain": 0}
    assert not any(kernels.composed_stats().values())
    tl = F.cross_entropy(got, _tbatch(arrs)[-1])
    jl = JF.cross_entropy(want, _jbatch(arrs)[-1])
    np.testing.assert_allclose(float(tl.detach()), float(jl.data),
                               atol=MODEL_ATOL)


def test_transformer_base_fp32_train_step_matches_reference():
    """One fp32 TrainStep: the loss, every gradient (read back from the
    reference's first moment, m1 = (1 - beta1) g) and every parameter
    after the Adam + NoamDecay update; then the schedulers step and a
    second step's loss agrees too. Launches: 6 masked forwards and
    backwards a step, 10 layer norms, one CE; all plain, none composed."""
    jm, tm = _pair()
    jst, tst, jsched, tsched = _steps(jm, tm, amp=False)
    grads = {}
    apply_fn = tst.optimizer.apply_fn

    def record(params, g, state, **kw):
        grads.update({k: v.clone() for k, v in g.items()})
        return apply_fn(params, g, state, **kw)

    tst.optimizer.apply_fn = record
    arrs = _padded_batch(1)
    kernels.reset_stats()
    np.testing.assert_allclose(float(tst(*_tbatch(arrs))),
                               float(jst(*_jbatch(arrs)).data),
                               atol=MODEL_ATOL)
    stats = kernels.all_stats()
    for name, n in {"layer_norm": 10, "flash_attention_masked": 6,
                    "flash_attention_bwd_masked": 6, "softmax_ce_fwd": 1,
                    "softmax_ce_bwd": 1}.items():
        assert stats[name] == {"kernel": 0, "plain": n}, name
    assert stats["flash_attention"]["plain"] == 0
    assert not any(kernels.composed_stats().values())
    assert set(grads) == set(jst.params)
    for k, g in grads.items():
        want = _np(jst.opt_state[k]["moment1"]) / (1 - 0.9)
        np.testing.assert_allclose(_np(g), want, atol=MODEL_ATOL, rtol=0,
                                   err_msg=k)
    lr = tsched.get_lr()
    assert lr == pytest.approx(jsched.get_lr())
    for k, p in jst.params.items():
        np.testing.assert_allclose(_np(tst.params[k]), _np(p),
                                   atol=2 * lr + MODEL_ATOL, rtol=0,
                                   err_msg=k)
    jsched.step()
    tsched.step()
    np.testing.assert_allclose(float(tst(*_tbatch(arrs))),
                               float(jst(*_jbatch(arrs)).data),
                               atol=MODEL_ATOL)


def test_transformer_base_o2_bf16_loss_tracks_reference():
    """Two O2 bf16 steps: the bool masks pass the step's casts uncast, the
    losses stay within 2e-2 of the reference's, and every attention takes
    the masked plain versions."""
    jm, tm = _pair()
    jst, tst, jsched, tsched = _steps(jm, tm, amp=True)
    arrs = _padded_batch(2)
    kernels.reset_stats()
    for _ in range(2):
        tl = tst(*_tbatch(arrs))
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(float(tl), float(jst(*_jbatch(arrs)).data),
                                   atol=O2_LOSS_ATOL)
        jsched.step()
        tsched.step()
    stats = kernels.all_stats()
    assert stats["flash_attention_masked"] == {"kernel": 0, "plain": 12}
    assert stats["flash_attention_bwd_masked"] == {"kernel": 0, "plain": 12}
    assert not any(kernels.composed_stats().values())
