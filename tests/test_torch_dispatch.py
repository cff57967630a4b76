"""Which route each kernel-backed entry of the port takes: the kernel (its
plain version on the CPU) or a torch composition, as the reference's
dispatch sends the same input to its Pallas kernel or to an XLA
composition (ROADMAP queue C, C1-C3).

Here there is no card, so the card's route is forced: each module's
``use_kernel`` is patched to answer True (a card) and its ``launch`` to
raise. An input the kernels do not take must then reach its composition
and ``kernels.composed_stats()``, never the launch; one they take must
reach the launch. The composed result is held against the route the CPU
takes for the same input (fp32 1e-5, fp16 2^-9 of the value's scale, as
``chip_smoke.py`` holds the card against the CPU), and the fp16
compositions against the JAX package's XLA path on the same numpy inputs.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import fused_bn as fbn
from paddle_tpu_torch.ops.kernels import layer_norm as ln
from paddle_tpu_torch.ops.kernels import softmax_ce as sce

#: composed route against the CPU route, of max(1, max |ref|): both
#: compute in fp32; fp16 results may round once more apart
TOL = {torch.float32: 1e-5, torch.float16: 2.0 ** -9}

#: the kernel counters each entry's kernels and plain versions move
ENTRY_KERNELS = {
    "layer_norm": ("layer_norm",),
    "flash_attention": ("flash_attention", "flash_attention_bwd",
                        "flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
    "softmax_ce": ("softmax_ce_fwd", "softmax_ce_bwd"),
    "fused_bn": ("fused_bn_fwd", "fused_bn_bwd_reduce", "fused_bn_bwd_dx")}


class LaunchReached(RuntimeError):
    pass


def _force_card_route(mp):
    """The four modules dispatch as on a card; any launch raises."""
    def launch(*args, **kw):
        raise LaunchReached(args[0])
    for mod in (fa, ln, sce, fbn):
        mp.setattr(mod, "use_kernel", lambda t: True)
        mp.setattr(mod, "launch", launch)


@pytest.fixture
def card_route(monkeypatch):
    _force_card_route(monkeypatch)


def _t(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dtype)


# ------------------------------ kernel_takes --------------------------------


def _qkv(B=2, Lq=16, Lk=16, H=2, D=64, dtype=torch.float32):
    return (torch.zeros(B, Lq, H, D, dtype=dtype),
            torch.zeros(B, Lk, H, D, dtype=dtype),
            torch.zeros(B, Lk, H, D, dtype=dtype))


@pytest.mark.parametrize("case", ["fp16", "fp64", "mixed", "causal_lq_gt_lk",
                                  "D_136", "D_12", "float_mask",
                                  "bool_mask"])
def test_flash_kernel_takes_refuses(case):
    q, k, v = _qkv()
    mask, causal = None, True
    if case == "fp16":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "fp64":
        q, k, v = (t.double() for t in (q, k, v))
    elif case == "mixed":
        v = v.bfloat16()
    elif case == "causal_lq_gt_lk":
        q, k, v = _qkv(Lq=16, Lk=8)
    elif case == "D_136":
        q, k, v = _qkv(D=136)
    elif case == "D_12":
        q, k, v = _qkv(D=12)
    elif case == "float_mask":
        mask = torch.zeros(2, 1, 16, 16)
    else:
        mask = torch.ones(2, 1, 16, 16, dtype=torch.bool)
    assert not fa.kernel_takes(q, k, v, mask, causal)


@pytest.mark.parametrize("shape,causal", [
    ((8, 1024, 1024, 12, 64), True),   # GPT-2 small training
    ((1, 32768, 32768, 12, 64), True),  # the long-context step
    ((4, 128, 128, 12, 64), False),    # BERT-base, unmasked
    ((1, 2048, 2048, 16, 128), True),  # the GPT-3 presets' head dim
    ((1, 37, 130, 3, 64), True),       # causal with Lq < Lk
    ((1, 100, 70, 3, 8), False)])      # Lq > Lk without causal
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_accepts(shape, causal, dtype):
    B, Lq, Lk, H, D = shape
    q = torch.empty(B, Lq, H, D, dtype=dtype, device="meta")
    k = torch.empty(B, Lk, H, D, dtype=dtype, device="meta")
    assert fa.kernel_takes(q, k, k, None, causal)


def test_kernel_design_follows_type_head_dim_and_alignment():
    """The tensor-core forward and split pair take bf16 at D 64 or 128
    with 16-byte aligned rows; everything else the CUDA-core kernels."""
    bf16 = torch.bfloat16
    q, k, v = torch.zeros(2, 16, 3, 4, 64, dtype=bf16).unbind(2)
    assert fa.kernel_design(q, k, v) == "mma.sync"
    assert fa.kernel_design(q, k, v, torch.zeros_like(q)) == "mma.sync"
    assert fa.kernel_design(*_qkv(D=128, dtype=bf16)) == "mma.sync"
    assert fa.kernel_design(*(t.float() for t in (q, k, v))) == "cuda-core"
    assert fa.kernel_design(*_qkv(D=32, dtype=bf16)) == "cuda-core"
    flat = torch.zeros(2 * 16 * 4 * 64 + 4, dtype=bf16)
    shifted = flat[4:].view(2, 16, 4, 64)  # rows start 8 bytes off
    assert fa.kernel_design(shifted, k, v) == "cuda-core"


def _one_pass_inputs(case):
    """q, k, v and dO of the one-pass backward for one design case."""
    bf16 = torch.bfloat16
    if case == "bf16_D64":
        return (*torch.zeros(2, 16, 3, 4, 64, dtype=bf16).unbind(2),
                torch.zeros(2, 16, 4, 64, dtype=bf16))
    if case == "bf16_D128":
        return (*_qkv(D=128, dtype=bf16), torch.zeros(2, 16, 2, 128,
                                                      dtype=bf16))
    if case == "fp32_D64":
        return (*_qkv(D=64), torch.zeros(2, 16, 2, 64))
    if case == "bf16_D96":
        return (*_qkv(D=96, dtype=bf16), torch.zeros(2, 16, 2, 96,
                                                     dtype=bf16))
    # dO's rows start one element (2 bytes) off a 16-byte boundary
    flat = torch.zeros(2 * 16 * 2 * 64 + 1, dtype=bf16)
    return (*_qkv(D=64, dtype=bf16), flat[1:].view(2, 16, 2, 64))


@pytest.mark.parametrize("case,design", [
    ("bf16_D64", "mma.sync"), ("bf16_D128", "mma.sync"),
    ("fp32_D64", "cuda-core"), ("bf16_D96", "cuda-core"),
    ("bf16_do_off_by_one", "cuda-core")])
def test_one_pass_backward_design(case, design):
    """The one-pass backward takes the tensor-core walk for bf16 at D 64
    or 128 when q, k, v and dO all have 16-byte aligned rows (the
    launcher's `tc_takes`), the CUDA-core walk otherwise; below the 6 MiB
    gate the backward is the one-pass kernel."""
    q, k, v, do = _one_pass_inputs(case)
    assert not fa.uses_split_bwd(q.shape[1], q.shape[-1])
    assert fa.kernel_design(q, k, v, do) == design


@pytest.mark.parametrize("x,g,b,takes", [
    (torch.float32, torch.float32, torch.float32, True),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, True),
    (torch.bfloat16, torch.float32, torch.float32, True),
    (torch.float16, torch.float32, torch.float32, False),
    (torch.float64, torch.float64, torch.float64, False),
    (torch.float32, torch.float16, torch.float16, False),
    (torch.float32, torch.float32, torch.bfloat16, False)])
def test_layer_norm_kernel_takes(x, g, b, takes):
    assert ln.kernel_takes(torch.ones(2, 8, dtype=x), torch.ones(8, dtype=g),
                           torch.ones(8, dtype=b)) is takes


@pytest.mark.parametrize("dtype,takes", [
    (torch.float32, True), (torch.bfloat16, True), (torch.float16, False),
    (torch.float64, False)])
def test_ce_and_bn_kernel_takes(dtype, takes):
    x = torch.ones(4, 8, dtype=dtype)
    assert sce.kernel_takes(x) is takes
    assert fbn.kernel_takes(x) is takes
    assert fbn.kernel_takes(x, x) is takes
    if takes:
        assert not fbn.kernel_takes(x, x.half())


# ---------------------- the card's route, forced here ------------------------


def _cases():
    """(id, entry, fn, inputs) of inputs the card must compose."""
    rng = np.random.default_rng(0)
    half = torch.float16
    B, L, H, D = 2, 24, 2, 16
    keep = torch.from_numpy(rng.random((B, 1, L, L)) > 0.3)

    def sdpa(q, k, v, mask=None, causal=False):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              is_causal=causal)

    def bn(x, g, b):
        return F.batch_norm(x, torch.zeros(8), torch.ones(8), g, b,
                            training=True, data_format="NHWC", act="relu")

    return [
        ("ln_fp16", "layer_norm", lambda x, g, b: F.layer_norm(x, 32, g, b),
         (_t(rng, 6, 32, dtype=half), (1 + 0.1 * _t(rng, 32)).to(half),
          (0.1 * _t(rng, 32)).to(half))),
        ("ln_fp64", "layer_norm", lambda x, g, b: F.layer_norm(x, 32, g, b),
         (_t(rng, 6, 32, dtype=torch.float64), 1 + 0.1 * _t(rng, 32),
          0.1 * _t(rng, 32))),
        ("attention_fp16", "flash_attention",
         lambda q, k, v: sdpa(q, k, v, causal=True),
         tuple(_t(rng, B, L, H, D, dtype=half) for _ in range(3))),
        ("float_mask", "flash_attention", sdpa,
         (*(_t(rng, B, L, H, D) for _ in range(3)),
          torch.where(keep, 0.0, -1e9))),
        ("bool_mask", "flash_attention",
         lambda q, k, v, m: sdpa(q, k, v, m, causal=True),
         (*(_t(rng, B, L, H, D) for _ in range(3)), keep)),
        ("causal_lq_gt_lk", "flash_attention",
         lambda q, k, v: sdpa(q, k, v, causal=True),
         (_t(rng, B, L, H, D), _t(rng, B, L // 2, H, D),
          _t(rng, B, L // 2, H, D))),
        ("head_dim_160", "flash_attention",
         lambda q, k, v: sdpa(q, k, v, causal=True),
         tuple(_t(rng, B, L, H, 160) for _ in range(3))),
        ("head_dim_12", "flash_attention", sdpa,
         tuple(_t(rng, B, L, H, 12) for _ in range(3))),
        ("ce_fp16", "softmax_ce", lambda x, lab: F.cross_entropy(x, lab),
         (_t(rng, 10, 50, dtype=half),
          torch.from_numpy(rng.integers(0, 50, 10)))),
        ("bn_fp16", "fused_bn", bn,
         (_t(rng, 2, 3, 3, 8, dtype=half), 1 + 0.1 * _t(rng, 8),
          0.1 * _t(rng, 8))),
    ]


CASES = _cases()


def _fwd_bwd(fn, inputs):
    leaves = [x.clone().requires_grad_(x.is_floating_point()) for x in inputs]
    out = fn(*leaves)
    cot = torch.from_numpy(np.random.default_rng(1).standard_normal(
        tuple(out.shape)).astype(np.float32)).to(out.dtype)
    grads = torch.autograd.grad(out, [x for x in leaves if x.requires_grad],
                                cot)
    return (out.detach(), *grads)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_card_route_composes_and_matches_cpu_route(case, monkeypatch):
    _, entry, fn, inputs = case
    want = _fwd_bwd(fn, inputs)  # the CPU's own route
    with monkeypatch.context() as mp:
        _force_card_route(mp)
        kernels.reset_stats()
        got = _fwd_bwd(fn, inputs)
        composed = kernels.composed_stats()
        stats = kernels.all_stats()
    assert composed[entry] == 1
    assert sum(composed.values()) == 1
    for name in ENTRY_KERNELS[entry]:
        assert stats[name] == {"kernel": 0, "plain": 0}, name
    tol = TOL[inputs[0].dtype if inputs[0].dtype != torch.float64
              else torch.float32]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        scale = max(1.0, float(w.double().abs().max()))
        err = float((g.double() - w.double()).abs().max())
        assert err <= tol * scale, (err, tol * scale)


def _bf16_qkv(D=64, Lq=16, Lk=16):
    rng = np.random.default_rng(2)
    return tuple(_t(rng, 1, L, 2, D, dtype=torch.bfloat16)
                 for L in (Lq, Lk, Lk))


@pytest.mark.parametrize("case", ["layer_norm", "flash_attention",
                                  "flash_attention_lq_lt_lk", "softmax_ce",
                                  "fused_bn"])
def test_card_route_launches_what_the_kernels_take(case, card_route):
    """Control: fp32/bf16 inputs the kernels take reach the launch."""
    kernels.reset_stats()
    with pytest.raises(LaunchReached):
        if case == "layer_norm":
            F.layer_norm(torch.ones(4, 8), 8, torch.ones(8), torch.zeros(8))
        elif case == "flash_attention":
            F.scaled_dot_product_attention(*_bf16_qkv(), is_causal=True)
        elif case == "flash_attention_lq_lt_lk":
            F.scaled_dot_product_attention(*_bf16_qkv(D=128, Lq=5, Lk=9),
                                           is_causal=True)
        elif case == "softmax_ce":
            F.cross_entropy(torch.ones(4, 8, dtype=torch.bfloat16),
                            torch.zeros(4, dtype=torch.int64))
        else:
            F.batch_norm(torch.ones(2, 2, 2, 8), torch.zeros(8),
                         torch.ones(8), torch.ones(8), torch.zeros(8),
                         training=True, data_format="NHWC", act="relu")
    assert not any(kernels.composed_stats().values())


def test_reset_stats_clears_the_composed_counts(card_route):
    F.layer_norm(torch.ones(2, 8).half(), 8, torch.ones(8).half(),
                 torch.zeros(8).half())
    assert kernels.composed_stats()["layer_norm"] >= 1
    kernels.reset_stats()
    assert not any(kernels.composed_stats().values())


# -------------------- fp16 compositions against the JAX package ---------------

#: fp16 outputs, compared in fp32 after the cast. Layer norm: both compute
#: in fp32 and round once to fp16, so they agree within one fp16 ulp
#: (2^-10 relative) plus 1e-5. Attention: the reference keeps its [L, L]
#: scores and probabilities in fp16 (``flash_attention_xla`` l.76-81)
#: where the port keeps fp32, so 4e-3 (two fp16 ulps of |out| < 4) of an
#: output near 1. Cross-entropy: an fp32 loss from fp16 logits on both
#: sides, 1e-5 relative.


def _j(a):
    return paddle.to_tensor(np.asarray(a))


def _jnp(t):
    return np.asarray(t.numpy(), np.float32)


def test_fp16_layer_norm_matches_jax_xla(card_route):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((12, 64)).astype(np.float16)
    g = (1 + 0.1 * rng.standard_normal(64)).astype(np.float16)
    b = (0.1 * rng.standard_normal(64)).astype(np.float16)
    want = _jnp(JF.layer_norm(_j(x), 64, _j(g), _j(b)))
    before = kernels.composed_stats()["layer_norm"]
    got = F.layer_norm(torch.from_numpy(x), 64, torch.from_numpy(g),
                       torch.from_numpy(b))
    assert got.dtype == torch.float16
    assert kernels.composed_stats()["layer_norm"] == before + 1
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -10,
                               atol=1e-5)


def test_fp16_attention_matches_jax_xla(card_route):
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 20, 2, 16)).astype(np.float16)
               for _ in range(3))
    want = _jnp(JF.scaled_dot_product_attention(_j(q), _j(k), _j(v),
                                                is_causal=True))
    before = kernels.composed_stats()["flash_attention"]
    got = F.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), is_causal=True)
    assert got.dtype == torch.float16
    assert kernels.composed_stats()["flash_attention"] == before + 1
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=4e-3)


def test_fp16_cross_entropy_matches_jax_xla(card_route):
    rng = np.random.default_rng(7)
    x = (2 * rng.standard_normal((16, 300))).astype(np.float16)
    lab = rng.integers(0, 300, 16)
    lab[3] = -100
    want = _jnp(JF.cross_entropy(_j(x), _j(lab.astype(np.int32)),
                                 reduction="none"))
    before = kernels.composed_stats()["softmax_ce"]
    got = F.cross_entropy(torch.from_numpy(x), torch.from_numpy(lab),
                          reduction="none")
    assert kernels.composed_stats()["softmax_ce"] == before + 1
    np.testing.assert_allclose(got.float().numpy(), want.reshape(-1),
                               rtol=1e-5, atol=1e-5)
