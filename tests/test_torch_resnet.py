"""The port's ResNet slice (paddle_tpu_torch: the fused BN family, the fused
1x1 conv + BN statistics chain, conv/pool/batch-norm functionals and
layers, models.resnet, jit.TrainStep with BN buffers, utils.convert)
against the JAX package, on the CPU.

The same numpy inputs and weights go to both packages. The kernel-level
cases run the JAX package's Pallas kernels in interpret mode, as its own
tests do; the interpret flags are switched only inside the
``interpret_mode`` fixture, which restores them (and the autotune state)
afterwards, so no other test file sees them. Every other case runs the
JAX package's XLA paths, and the port its plain versions through the same
autograd Functions a card uses.

Tolerances:
- fp32 forward outputs, batch statistics, running statistics and losses:
  rtol 1e-5 of each tensor's largest magnitude (sums in another order);
- fp32 gradients: 2e-3 of each leaf's largest |g| (cotangents summed in
  another order);
- the whole ResNet-50 step, whose fp32 gradient moves by several per cent
  when the batch is only reordered (in either package, at every size
  tried), in relative L2, between the port's own rounding noise and a
  10 % backward error: see its test;
- bf16: one rounding, 2^-8 of each tensor's largest magnitude, where both
  packages round the same fp32 values; a bottleneck block in bf16, where
  each package rounds its activations at its own points and three batch
  norms renormalise them, is held to 2^-6 (two roundings by each side
  through one normalisation step, amplified by at most 2 by the next).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.jit import functionalize as jfunctionalize
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import autotune as jautotune
from paddle_tpu.ops.pallas import fused_bn as jfb
from paddle_tpu.ops.pallas import fused_conv_bn as jfcb
from paddle_tpu_torch import jit, nn, optimizer
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import _bn_common, kernels
from paddle_tpu_torch.ops.kernels import fused_bn as fb
from paddle_tpu_torch.ops.kernels import fused_conv_bn as fcb
from paddle_tpu_torch.utils.convert import load_numpy_params, \
    load_train_state

EPS = 1e-5
RTOL32 = 1e-5
GRAD_TOL = 2e-3
BF16_ONE = 2.0 ** -8
BF16_BLOCK = 2.0 ** -6
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture()
def interpret_mode(monkeypatch):
    """The JAX package's Pallas kernels in the interpreter, with static
    autotune picks; everything restored afterwards."""
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE", "0")
    old_f, old_b = jfcb._INTERPRET, jfb._INTERPRET
    jfcb._INTERPRET = jfb._INTERPRET = True
    jfcb._probe_status.clear()
    jfb._probe_status.clear()
    jautotune.reset_for_tests()
    yield
    jfcb._INTERPRET, jfb._INTERPRET = old_f, old_b
    jfcb._probe_status.clear()
    jfb._probe_status.clear()
    jautotune.reset_for_tests()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    if isinstance(x, JTensor):
        x = x.data
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(a, dtype="float32"):
    """The same numpy array as a jax and a torch array of `dtype`."""
    a = np.asarray(a, np.float32)
    return (jnp.asarray(a).astype(jnp.dtype(dtype)),
            torch.from_numpy(a).to(TDT[dtype]))


def _close(got, want, rel, what=""):
    """|got - want| <= rel * max |want| (at least 1e-30)."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = max(float(np.abs(w).max()), 1e-30)
    np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale, err_msg=what)


# ----------------------------- kernel level ----------------------------------


def _bn_operands(rng, R, C, dtype):
    x = rng.normal(size=(R, C))
    z = rng.normal(size=(R, C))
    dy = rng.normal(size=(R, C))
    mean = rng.normal(size=C) * 0.1
    inv = 1.0 + 0.2 * rng.random(C)
    k = rng.normal(size=C)
    c = rng.normal(size=C) * 0.5
    vec = [_pair(v, "float32") for v in (mean, inv, k, c)]
    rows = [_pair(v, dtype) for v in (x, z, dy)]
    return rows, vec


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["relu", None])
@pytest.mark.parametrize("has_add", [False, True])
@pytest.mark.parametrize("R", [256, 264])
def test_fused_bn_kernels_plain_match_pallas(dtype, act, has_add, R):
    """The three fused-BN plain versions against the Pallas kernels in
    interpret mode, at a whole (256) and a ragged (264) row count."""
    rng = np.random.default_rng(R + 2 * has_add + (act is None))
    C = 128
    ((jx, tx), (jz, tz), (jdy, tdy)), \
        ((jm, tm), (ji, ti), (jk, tk), (jc, tc)) = _bn_operands(rng, R, C,
                                                                dtype)
    jzz, tzz = (jz, tz) if has_add else (None, None)
    jy = jfb._bn_act_fwd_pallas(jx, jzz, jk, jc, act=act, has_add=has_add,
                                interpret=True)
    ty = fb.bn_act_fwd(tx, tzz, tk, tc, act)
    assert ty.dtype == TDT[dtype]
    _close(ty, jy, RTOL32 if dtype == "float32" else BF16_ONE, "y")
    # the backward takes the reference's y, so the ReLU masks agree
    ty = torch.from_numpy(np.array(_np(jy))).to(TDT[dtype])
    jdb, jdg = jfb._bn_bwd_reduce_pallas(jx, jy, jdy, jm, ji, act=act,
                                         interpret=True)
    tdb, tdg = fb.bn_bwd_reduce(tx, ty, tdy, tm, ti, act)
    _close(tdb, jdb, RTOL32, "dbeta")
    _close(tdg, jdg, RTOL32, "dgamma")
    outs = jfb._bn_bwd_dx_pallas(jx, jy, jdy, jk, jc, jm, act=act,
                                 has_add=has_add, interpret=True)
    tdx, tdz = fb.bn_bwd_dx(tx, ty, tdy, tk, tc, tm, act, has_add)
    _close(tdx, outs[0], RTOL32 if dtype == "float32" else BF16_ONE, "dx")
    if has_add:
        _close(tdz, outs[1], 0.0, "dz")
    else:
        assert tdz is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1x1_stats_plain_matches_pallas(dtype):
    rng = np.random.default_rng(5)
    R, Cin, Cout = 256, 128, 256
    jx, tx = _pair(rng.normal(size=(R, Cin)), dtype)
    w = rng.normal(size=(Cout, Cin)) * 0.05
    jw, tw = _pair(w.T, dtype)  # the reference takes [Cin, Cout]
    ty, ts, tss = fcb.conv1x1_stats(tx, tw.t().contiguous())
    jy, js, jss = jfcb._conv1x1_stats_pallas(jx, jw, interpret=True)
    assert ty.dtype == TDT[dtype] and ts.dtype == torch.float32
    tol = RTOL32 if dtype == "float32" else BF16_ONE
    _close(ty, jy, tol, "y")
    # the sums are of y as stored: each held to tol of the sum of its
    # terms' magnitudes (an element may round to its other neighbour)
    yst = ty.float()
    for got, want, terms, what in ((ts, js, yst.abs(), "sum"),
                                   (tss, jss, yst * yst, "sumsq")):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=tol * 2 * float(terms.sum(0).max()),
                                   err_msg=what)


@pytest.mark.parametrize("has_add", [False, True])
@pytest.mark.parametrize("act", ["relu", None])
def test_conv_chain_matches_reference(interpret_mode, has_add, act):
    """fused_conv1x1_bn_act: y, batch statistics and the gradients of x,
    w, gamma, beta (and z) against the reference's chain, its kernels
    interpreted (N 4, 8x8, Cin 128 -> Cout 256)."""
    rng = np.random.default_rng(6)
    N, H, W, Cin, Cout = 4, 8, 8, 128, 256
    a = dict(x=rng.normal(size=(N, H, W, Cin)),
             w=rng.normal(size=(Cout, Cin, 1, 1)) * 0.05,
             g=rng.normal(size=Cout), b=rng.normal(size=Cout),
             z=rng.normal(size=(N, H, W, Cout)),
             dy=rng.normal(size=(N, H, W, Cout)))
    J = {k: jnp.asarray(v.astype(np.float32)) for k, v in a.items()}
    T = {k: torch.from_numpy(v.astype(np.float32)).requires_grad_(k != "dy")
         for k, v in a.items()}

    def jf(x, w, g, b, z):
        y, m, v = jfcb.fused_conv1x1_bn_act(
            x, w, g, b, residual=z if has_add else None, epsilon=EPS,
            act=act)
        return jnp.sum(y * J["dy"]), (y, m, v)

    before = jfcb._stats["pallas_fwd"]
    (_, (jy, jm, jv)), jg = jax.value_and_grad(jf, argnums=(0, 1, 2, 3, 4),
                                               has_aux=True)(
        J["x"], J["w"], J["g"], J["b"], J["z"])
    assert jfcb._stats["pallas_fwd"] > before, "reference kernel not taken"
    assert fcb.eligible(T["x"].shape, T["w"].shape, 1, 0, 1, 1, "NHWC",
                        torch.float32)
    ty, tm, tv = fcb.fused_conv1x1_bn_act(
        T["x"], T["w"], T["g"], T["b"], residual=T["z"] if has_add else None,
        epsilon=EPS, act=act)
    for got, want, what in ((ty, jy, "y"), (tm, jm, "mean"),
                            (tv, jv, "var")):
        _close(got, want, RTOL32, what)
    (ty * T["dy"]).sum().backward()
    for i, k in enumerate(("x", "w", "g", "b", "z")):
        if k == "z" and not has_add:
            assert T["z"].grad is None
            continue
        _close(T[k].grad, jg[i], GRAD_TOL, f"grad {k}")


def test_fused_bn_nchw_and_function_guards():
    """NCHW data goes through a channels-last copy; the outputs carry
    grad_fns on the CPU as on a card; bad arguments raise."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(2, 8, 3, 5)).astype(np.float32))
    g, b = torch.ones(8, requires_grad=True), torch.zeros(8)
    x.requires_grad_(True)
    y, m, v = fb.fused_bn_relu(x, g, b, data_format="NCHW")
    ref = F._BNTrainFunction.apply(x, g, b, EPS, "NCHW")
    np.testing.assert_allclose(_np(y), np.maximum(_np(ref[0]), 0),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(m), _np(ref[1]), rtol=0, atol=1e-6)
    assert y.grad_fn is not None and y.shape == x.shape
    with pytest.raises(ValueError):
        fb._check_rows("t", torch.ones(4, 3), torch.ones(4, 3).double())
    with pytest.raises(ValueError):
        fb._check_rows("t", torch.ones(4, 3).half())
    with pytest.raises(ValueError):
        fb._check_channels("t", 3, torch.ones(3, dtype=torch.float64))
    with pytest.raises(ValueError):
        fb._is_relu("gelu")
    with pytest.raises(ValueError):
        fcb.check_args(torch.ones(4, 12), torch.ones(8, 12))
    with pytest.raises(ValueError):
        fcb.check_args(torch.ones(4, 16).bfloat16(), torch.ones(8, 16))


@pytest.mark.parametrize("case", [
    ("NHWC", (2, 8, 8, 64), (64, 64, 1, 1), 1, 0, 1, 1, torch.float32, True),
    ("NHWC", (2, 8, 8, 64), (256, 64, 1, 1), 1, "VALID", 1, 1,
     torch.bfloat16, True),
    ("NHWC", (2, 8, 8, 64), (64, 64, 1, 1), 2, 0, 1, 1, torch.float32,
     False),
    ("NHWC", (2, 8, 8, 64), (64, 64, 3, 3), 1, 1, 1, 1, torch.float32,
     False),
    ("NCHW", (2, 64, 8, 8), (64, 64, 1, 1), 1, 0, 1, 1, torch.float32,
     False),
    ("NHWC", (2, 8, 8, 12), (64, 12, 1, 1), 1, 0, 1, 1, torch.float32,
     False),
    ("NHWC", (2, 8, 8, 64), (64, 32, 1, 1), 1, 0, 1, 2, torch.float32,
     False),
    ("NHWC", (2, 8, 8, 64), (64, 64, 1, 1), 1, 0, 1, 1, torch.float16,
     False),
])
def test_conv_chain_gate(case):
    """The port's own gate: NHWC, 1x1, stride 1, no padding, one group,
    Cin and Cout multiples of 8, fp32/bf16."""
    df, xs, ws, stride, pad, dil, groups, dtype, want = case
    assert fcb.eligible(xs, ws, stride, pad, dil, groups, df, dtype) is want


@pytest.mark.parametrize("R,dtype,rows", [
    # one per 128-row tile, the most the persistent grid writes
    (100352, torch.bfloat16, 784),   # layer2
    (6272, torch.bfloat16, 49),      # layer4
    (100, torch.bfloat16, 1),        # one tile
    (129, torch.bfloat16, 2),        # R off the tile
    (1, torch.bfloat16, 1),
    (1000, torch.float32, 8),        # fp32: the same tiles
    (128, torch.float32, 1),
    (129, torch.float32, 2)])
def test_conv_partial_rows_follow_the_tiles(R, dtype, rows):
    assert fcb.TILE_ROWS == {torch.bfloat16: 128, torch.float32: 128}
    assert fcb.partial_rows(R, dtype) == rows


@pytest.mark.parametrize("R,Cin,Cout,dtype", [
    (100352, 512, 128, torch.bfloat16), (300, 520, 72, torch.bfloat16),
    (6272, 512, 2048, torch.bfloat16), (1000, 64, 24, torch.float32)])
def test_conv_wrapper_sizes_the_partials_it_launches(R, Cin, Cout, dtype,
                                                    monkeypatch):
    """On the card's route the wrapper allocates [partial_rows, 2, Cout]
    fp32 partials, passes that count to the launch as the rows the
    kernel may write (and, for fp32, scratch for w's two TF32 planes),
    and counts the launch under its design and shape."""
    seen = {}

    def launch(name, entry, device, x, w, y, part, wsplit, out, r, cin,
               cout, cap, bf16):
        seen.update(r=r, cin=cin, cout=cout, cap=cap, bf16=bf16,
                    wsplit=wsplit is not None)

    monkeypatch.setattr(fcb, "use_kernel", lambda t: True)
    monkeypatch.setattr(fcb, "launch", launch)
    kernels.reset_stats()
    fcb.conv1x1_stats(torch.zeros(R, Cin, dtype=dtype),
                      torch.zeros(Cout, Cin, dtype=dtype))
    assert seen == dict(r=R, cin=Cin, cout=Cout, bf16=int(
        dtype == torch.bfloat16), cap=fcb.partial_rows(R, dtype),
        wsplit=dtype == torch.float32)
    design = "wgmma-tma" if dtype == torch.bfloat16 else "wgmma-3xtf32"
    assert kernels.design_stats()["conv1x1_stats"] == {design: 1}
    assert kernels.shape_stats()["conv1x1_stats"] == {
        f"R={R} Cin={Cin} Cout={Cout}": 1}
    kernels.reset_stats()


def test_kernel_counters_and_cpu_plain_runs():
    kernels.reset_stats()
    x = torch.randn(16, 8)
    fb.bn_act_fwd(x, None, torch.ones(8), torch.zeros(8), "relu")
    fb.bn_bwd_reduce(x, x, x, torch.zeros(8), torch.ones(8), None)
    fb.bn_bwd_dx(x, x, x, torch.ones(8), torch.ones(8), torch.ones(8),
                 "relu", True)
    fcb.conv1x1_stats(x, torch.randn(16, 8))
    st = kernels.all_stats()
    for name in ("fused_bn_fwd", "fused_bn_bwd_reduce", "fused_bn_bwd_dx",
                 "conv1x1_stats"):
        assert st[name] == {"kernel": 0, "plain": 1}, name
    assert fb.reduce_chunks(1) == 1
    assert fb.reduce_chunks(1_605_632) == fb.REDUCE_MAX_CHUNKS


# ------------------------------ functionals ----------------------------------


@pytest.mark.parametrize("df,stride,padding,dilation,groups", [
    ("NCHW", 1, 0, 1, 1), ("NHWC", 2, 3, 1, 1), ("NHWC", 2, "SAME", 1, 1),
    ("NCHW", 1, "VALID", 2, 1), ("NHWC", 1, [0, 1, 2, 1], 1, 2)])
def test_conv2d_matches_reference(df, stride, padding, dilation, groups):
    rng = np.random.default_rng(8)
    shape = (2, 4, 9, 7) if df == "NCHW" else (2, 9, 7, 4)
    jx, tx = _pair(rng.normal(size=shape))
    jw, tw = _pair(rng.normal(size=(6, 4 // groups, 3, 3)))
    jb, tb = _pair(rng.normal(size=6))
    want = JF.conv2d(paddle.to_tensor(np.asarray(jx)),
                     paddle.to_tensor(np.asarray(jw)),
                     paddle.to_tensor(np.asarray(jb)), stride, padding,
                     dilation, groups, df)
    got = F.conv2d(tx, tw, tb, stride, padding, dilation, groups, df)
    _close(got, want, RTOL32, "conv2d")


def test_nhwc_conv_is_a_view():
    """NHWC runs on a channels-last view: the output is a permuted view of
    channels-last memory, and nothing copies the input."""
    x = torch.randn(2, 8, 8, 16)
    w = torch.randn(32, 16, 3, 3)
    y = F.conv2d(x, w, None, 1, 1, 1, 1, "NHWC")
    assert y.shape == (2, 8, 8, 32) and y.is_contiguous()


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
def test_pooling_matches_reference(df):
    rng = np.random.default_rng(9)
    shape = (2, 3, 10, 10) if df == "NCHW" else (2, 10, 10, 3)
    jx, tx = _pair(rng.normal(size=shape))
    jt = paddle.to_tensor(np.asarray(jx))
    _close(F.max_pool2d(tx, 3, 2, 1, data_format=df),
           JF.max_pool2d(jt, 3, 2, 1, data_format=df), 0.0, "max_pool2d")
    _close(F.adaptive_avg_pool2d(tx, (1, 1), df),
           JF.adaptive_avg_pool2d(jt, (1, 1), df), RTOL32, "avg (1, 1)")
    _close(F.adaptive_avg_pool2d(tx, 5, df),
           JF.adaptive_avg_pool2d(jt, 5, df), RTOL32, "avg 5")
    with pytest.raises(NotImplementedError):
        F.adaptive_avg_pool2d(tx, 3, df)
    with pytest.raises(NotImplementedError):
        F.max_pool2d(tx, 3, 2, 1, ceil_mode=True, data_format=df)
    assert F.flatten(tx, 1).shape == (2, 300)


def _bn_ref_state(C):
    return (paddle.to_tensor(np.zeros(C, np.float32)),
            paddle.to_tensor(np.ones(C, np.float32)))


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
@pytest.mark.parametrize("act,residual", [(None, False), ("relu", False),
                                          ("relu", True), (None, True)])
def test_batch_norm_train_matches_reference(df, act, residual):
    """F.batch_norm in training mode: output, gradients of x, weight, bias
    (and residual) and the running statistics after the step, against the
    reference's unfused and fused paths."""
    rng = np.random.default_rng(10)
    C = 6
    shape = (3, C, 4, 5) if df == "NCHW" else (3, 4, 5, C)
    vals = dict(x=rng.normal(size=shape) * 2 + 1, z=rng.normal(size=shape),
                w=rng.normal(size=C), b=rng.normal(size=C),
                dy=rng.normal(size=shape))
    J = {k: paddle.to_tensor(v.astype(np.float32), stop_gradient=False)
         for k, v in vals.items()}
    T = {k: torch.from_numpy(v.astype(np.float32)).requires_grad_(True)
         for k, v in vals.items()}
    jrm, jrv = _bn_ref_state(C)
    trm, trv = torch.zeros(C), torch.ones(C)
    jout = JF.batch_norm(J["x"], jrm, jrv, J["w"], J["b"], training=True,
                         momentum=0.9, data_format=df, act=act,
                         residual=J["z"] if residual else None)
    tout = F.batch_norm(T["x"], trm, trv, T["w"], T["b"], training=True,
                        momentum=0.9, data_format=df, act=act,
                        residual=T["z"] if residual else None)
    _close(tout, jout, RTOL32, "out")
    _close(trm, jrm, RTOL32, "running mean")
    _close(trv, jrv, RTOL32, "running var")
    (jout * J["dy"]).sum().backward()
    (tout * T["dy"]).sum().backward()
    for k in ("x", "w", "b") + (("z",) if residual else ()):
        _close(T[k].grad, J[k].grad, GRAD_TOL, f"grad {k}")


@pytest.mark.parametrize("act,residual", [(None, False), ("relu", True)])
def test_batch_norm_eval_matches_reference(act, residual):
    rng = np.random.default_rng(11)
    C = 5
    x = rng.normal(size=(2, 3, 3, C)).astype(np.float32)
    z = rng.normal(size=(2, 3, 3, C)).astype(np.float32)
    rm = rng.normal(size=C).astype(np.float32)
    rv = (1 + rng.random(C)).astype(np.float32)
    w, b = rng.normal(size=C).astype(np.float32), rng.normal(
        size=C).astype(np.float32)
    P = paddle.to_tensor
    want = JF.batch_norm(P(x), P(rm), P(rv), P(w), P(b), training=False,
                         data_format="NHWC", act=act,
                         residual=P(z) if residual else None)
    T = torch.from_numpy
    got = F.batch_norm(T(x), T(rm), T(rv), T(w), T(b), training=False,
                       data_format="NHWC", act=act,
                       residual=T(z) if residual else None)
    _close(got, want, RTOL32, "eval")


def test_bn_stats_formula():
    """One-pass E[x^2] - E[x]^2, clamped at 0, in fp32 for bf16 input."""
    x = torch.tensor([[1.0, 3.0], [3.0, 3.0]]).bfloat16()
    mean, var = _bn_common._bn_stats(x, (0,))
    assert mean.dtype == torch.float32
    assert mean.tolist() == [2.0, 3.0] and var.tolist() == [1.0, 0.0]
    axes, shape = _bn_common._bn_axes(torch.ones(2, 3, 4, 5), "NCHW")
    assert axes == (0, 2, 3) and shape == [1, 3, 1, 1]


@pytest.mark.parametrize("residual", [False, True])
def test_conv2d_bn_matches_reference(residual):
    """F.conv2d_bn on a fused-eligible 1x1 shape and on a 3x3 (conv then
    fused BN), in training mode; the running statistics too."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 4, 4, 16)).astype(np.float32)
    z = rng.normal(size=(2, 4, 4, 24)).astype(np.float32)
    g = rng.normal(size=24).astype(np.float32)
    b = rng.normal(size=24).astype(np.float32)
    P, T = paddle.to_tensor, torch.from_numpy
    for k, pad in ((1, 0), (3, 1)):
        w = (rng.normal(size=(24, 16, k, k)) * 0.1).astype(np.float32)
        jrm, jrv = _bn_ref_state(24)
        trm, trv = torch.zeros(24), torch.ones(24)
        want = JF.conv2d_bn(P(x), P(w), jrm, jrv, P(g), P(b), training=True,
                            padding=pad, data_format="NHWC", act="relu",
                            residual=P(z) if residual else None)
        kernels.reset_stats()
        got = F.conv2d_bn(T(x), T(w), trm, trv, T(g), T(b), training=True,
                          padding=pad, data_format="NHWC", act="relu",
                          residual=T(z) if residual else None)
        assert kernels.all_stats()["conv1x1_stats"]["plain"] == (k == 1)
        _close(got, want, RTOL32, f"conv2d_bn k={k}")
        _close(trm, jrm, RTOL32, "running mean")
        _close(trv, jrv, RTOL32, "running var")


# ------------------------------- block level ---------------------------------


def _export(jlayer):
    """{name: numpy} of a JAX layer's parameters and buffers."""
    out = {k: np.asarray(v.data) for k, v in jlayer.named_parameters()}
    out.update({k: np.asarray(v.data) for k, v in jlayer.named_buffers()})
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bottleneck_block_matches_reference(dtype):
    """BottleneckBlock(512, 128, NHWC) in training mode: output, every
    parameter's gradient and the running statistics after one forward,
    with the parameters and input in `dtype` (the fp32 masters' gradients,
    as TrainStep forms them)."""
    paddle.seed(0)
    jb = jresnet.BottleneckBlock(512, 128, data_format="NHWC")
    tb = tresnet.BottleneckBlock(512, 128, data_format="NHWC", device="cpu")
    load_numpy_params(tb, _export(jb))
    jb.train(), tb.train()
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 8, 8, 512)).astype(np.float32)
    dy = rng.normal(size=(2, 8, 8, 512)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), TDT[dtype]
    apply_fn, jparams, jbuf = jfunctionalize(jb)

    def jloss(p):
        pc = {k: v.astype(jdt) for k, v in p.items()}
        out, nb = apply_fn(pc, jbuf, None, jnp.asarray(x).astype(jdt))
        return jnp.sum(out.astype(jnp.float32) * dy), (out, nb)

    (_, (jout, jnb)), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tapply, tparams, tbuf = jit.functionalize(tb)
    masters = {k: v.detach().clone().requires_grad_(True)
               for k, v in tparams.items()}
    tb_buf = {k: v.clone() for k, v in tbuf.items()}
    tout, tnb = tapply({k: v.to(tdt) for k, v in masters.items()}, tb_buf,
                       torch.from_numpy(x).to(tdt))
    assert tout.dtype == tdt
    (tout.float() * torch.from_numpy(dy)).sum().backward()
    tol = RTOL32 if dtype == "float32" else BF16_BLOCK
    gtol = GRAD_TOL if dtype == "float32" else BF16_BLOCK
    _close(tout, jout, tol, "out")
    for k in jparams:
        _close(masters[k].grad, jg[k], gtol, f"grad {k}")
    for k in jbuf:
        assert tnb[k].dtype == torch.float32
        _close(tnb[k], jnb[k], tol, f"buffer {k}")


def test_block_fused_path_counts():
    """A bottleneck in training mode: two fused 1x1 chains (conv1, conv3),
    three fused-BN forwards and, after backward, three reduce and dx
    launches (plain versions on the CPU)."""
    blk = tresnet.BottleneckBlock(64, 16, data_format="NHWC", device="cpu")
    kernels.reset_stats()
    blk(torch.randn(2, 4, 4, 64, requires_grad=True)).sum().backward()
    st = kernels.all_stats()
    assert st["conv1x1_stats"]["plain"] == 2
    for name in ("fused_bn_fwd", "fused_bn_bwd_reduce", "fused_bn_bwd_dx"):
        assert st[name]["plain"] == 3, name
    blk.eval()
    kernels.reset_stats()
    blk(torch.randn(2, 4, 4, 64))
    assert all(v["plain"] == 0 for v in kernels.all_stats().values())


# ------------------------------- whole model ---------------------------------


def _grad_gaps(tgrads, jgrads):
    """(whole-gradient relative L2, worst leaf's relative L2) of
    {name: gradient} against the reference's."""
    num = den = 0.0
    leaf = 0.0
    for k, jg in jgrads.items():
        t, j = _np(tgrads[k]), _np(jg)
        d2, n2 = float(np.sum((t - j) ** 2)), float(np.sum(j ** 2))
        num, den = num + d2, den + n2
        leaf = max(leaf, (d2 / max(n2, 1e-60)) ** 0.5)
    return (num / den) ** 0.5, leaf


def _port_resnet50_step(arrays, x, y, lr):
    tm = tresnet.resnet50(num_classes=10, data_format="NHWC", device="cpu")
    load_numpy_params(tm, arrays)
    tst = jit.TrainStep(tm, F.cross_entropy, optimizer.Momentum(
        learning_rate=lr, momentum=0.9, parameters=tm.parameters()))
    loss = float(tst(torch.from_numpy(x), torch.from_numpy(
        y.astype(np.int64))))
    return tst, loss, {k: s["velocity"] for k, s in tst.opt_state.items()}


def test_resnet50_train_step_matches_reference(monkeypatch):
    """resnet50 (NHWC, 10 classes) TrainStep in fp32 with Momentum(0.1,
    0.9) at B 2, 64x64: the loss, every gradient (the reference's read back
    from its velocity, which after one step is the gradient), every
    parameter after the step and every running statistic.

    The fp32 step of this randomly initialised network is ill-conditioned
    at every size tried, not only at this one: either package's gradient
    moves by several per cent in relative L2 when the batch is merely
    reordered, and most leaves move by more than 2e-3 of their scale (see
    test_resnet50_step_parity_is_fp32_limited for the readings at B 2 and
    8, 64x64 and 128x128). So the gradient is held in relative L2: the
    loss to 1e-3 of itself, the whole gradient to 10 % and each leaf to
    15 %, each parameter's update the same, the running statistics to 1e-3
    of each buffer's scale. The test also measures what those bounds sit
    between: the port's own rounding noise (the same batch in the other
    order, the same function summed in another order) must pass them, and
    a 10 % error in one term of the fused BN backward must fail them.
    Per-element gradient parity (2e-3 of a leaf's scale) is held at block
    level, above."""
    paddle.seed(0)
    jm = jresnet.resnet50(num_classes=10, data_format="NHWC")
    arrays = _export(jm)
    rng = np.random.default_rng(14)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    y = np.array([3, 7], np.int32)
    lr = 0.1
    jst = JTrainStep(jm, JF.cross_entropy, jopt.Momentum(
        learning_rate=lr, momentum=0.9, parameters=jm.parameters()))
    jl = float(_np(jst(paddle.to_tensor(x), paddle.to_tensor(y))))
    jgrads = {k: s["velocity"] for k, s in jst.opt_state.items()}
    kernels.reset_stats()
    tst, tl, tgrads = _port_resnet50_step(arrays, x, y, lr)
    st = kernels.all_stats()
    assert st["conv1x1_stats"]["plain"] == 32
    for name in ("fused_bn_fwd", "fused_bn_bwd_reduce", "fused_bn_bwd_dx"):
        assert st[name]["plain"] == 49, name
    whole, leaf = _grad_gaps(tgrads, jgrads)
    print(f"\nport vs reference: loss {abs(tl - jl) / abs(jl):.3e}, "
          f"gradient {whole:.4f} whole, {leaf:.4f} worst leaf")
    assert abs(tl - jl) <= 1e-3 * abs(jl)
    assert whole <= 0.10 and leaf <= 0.15
    for k in jgrads:
        # the update moved each parameter by lr times its own gradient
        step_t = arrays[k] - _np(tst.params[k])
        step_j = arrays[k] - _np(jst.params[k])
        np.testing.assert_allclose(step_t, lr * _np(tgrads[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
        assert _grad_gaps({k: step_t}, {k: step_j})[1] <= 0.15, k
    assert set(tst.buffers) == set(jst.buffers) and len(tst.buffers) == 106
    for k, v in jst.buffers.items():
        assert tst.buffers[k].dtype == torch.float32
        _close(tst.buffers[k], v, 1e-3, f"buffer {k}")

    # the port's own noise: the batch in the other order
    _, rl, rgrads = _port_resnet50_step(arrays, x[::-1].copy(), y[::-1],
                                        lr)
    s_whole, s_leaf = _grad_gaps(rgrads, tgrads)
    print(f"port vs itself, batch reversed: loss "
          f"{abs(rl - tl) / abs(tl):.3e}, gradient {s_whole:.4f} whole, "
          f"{s_leaf:.4f} worst leaf")
    assert s_whole <= 0.10 and s_leaf <= 0.15
    # a 10 % error in the B (dgamma) term of the fused BN backward
    dx_kernel = fb.bn_bwd_dx
    monkeypatch.setattr(fb, "bn_bwd_dx", lambda x2d, y2d, dy2d, a, b, c0,
                        act, has_add: dx_kernel(x2d, y2d, dy2d, a, 0.9 * b,
                                                c0, act, has_add))
    _, _, mgrads = _port_resnet50_step(arrays, x, y, lr)
    m_whole, m_leaf = _grad_gaps(mgrads, jgrads)
    print(f"mutated backward vs reference: gradient {m_whole:.4f} whole, "
          f"{m_leaf:.4f} worst leaf")
    assert m_whole > 0.10 or m_leaf > 0.15


def _leaf_readings(a, b):
    """(whole relative L2, worst leaf's relative L2, worst leaf's
    max |a - b| / max |b|, leaves whose max |a - b| passes 2e-3 of their
    max |b|) of gradients {name: array} a against b."""
    whole, leaf = _grad_gaps(a, b)
    scaled = [float(np.abs(_np(a[k]) - _np(v)).max()
                    / max(float(np.abs(_np(v)).max()), 1e-30))
              for k, v in b.items()]
    return whole, leaf, max(scaled), sum(x > GRAD_TOL for x in scaled)


@pytest.mark.slow  # two whole-model steps of each package at each size;
# the fast sibling is test_resnet50_train_step_matches_reference
@pytest.mark.parametrize("B,hw", [(2, 64), (8, 64), (2, 128), (8, 128)])
def test_resnet50_step_parity_is_fp32_limited(B, hw, monkeypatch):
    """Why the whole-model case holds its gradient in relative L2 and not
    to GRAD_TOL per leaf, at sizes where layer4's batch norms see 8 to 128
    rows. Each package's fp32 gradient is read against the same package's
    step on the batch in the other order, and the port's against its own
    fp64 step (every plain version run in fp64). The readings are printed
    (run with -s); the test holds the port-to-reference gap, in relative
    L2, within 1.5 times the two packages' own batch-order noise, and
    holds that the reference misses GRAD_TOL per leaf against itself in
    most leaves. When that last check fails, the reference has become
    well-conditioned and the whole-model case should hold GRAD_TOL per
    leaf again."""
    paddle.seed(0)
    jm = jresnet.resnet50(num_classes=10, data_format="NHWC")
    arrays = _export(jm)
    rng = np.random.default_rng(14)
    x = rng.normal(size=(B, hw, hw, 3)).astype(np.float32)
    y = (np.arange(B) * 4 + 3).astype(np.int32) % 10
    xr, yr = x[::-1].copy(), y[::-1].copy()

    def ref(xx, yy):
        paddle.seed(0)
        m = jresnet.resnet50(num_classes=10, data_format="NHWC")
        st = JTrainStep(m, JF.cross_entropy, jopt.Momentum(
            learning_rate=0.1, momentum=0.9, parameters=m.parameters()))
        st(paddle.to_tensor(xx), paddle.to_tensor(yy))
        return {k: s["velocity"] for k, s in st.opt_state.items()}

    jg, jrg = ref(x, y), ref(xr, yr)
    tg = _port_resnet50_step(arrays, x, y, 0.1)[2]
    trg = _port_resnet50_step(arrays, xr, yr, 0.1)[2]
    tm = tresnet.resnet50(num_classes=10, data_format="NHWC", device="cpu")
    load_numpy_params(tm, arrays)
    tm.to(torch.float64)
    st64 = jit.TrainStep(tm, F.cross_entropy, optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=tm.parameters()))
    as_fp32 = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float", lambda t, *a, **k: t if
                        t.dtype == torch.float64 else as_fp32(t, *a, **k))
    st64(torch.from_numpy(x).double(), torch.from_numpy(y.astype(np.int64)))
    monkeypatch.undo()
    g64 = {k: s["velocity"].double().numpy() for k, s in
           st64.opt_state.items()}
    assert all(s["velocity"].dtype == torch.float64
               for s in st64.opt_state.values())
    readings = {
        "port vs reference": _leaf_readings(tg, jg),
        "reference vs itself, batch reversed": _leaf_readings(jrg, jg),
        "port vs itself, batch reversed": _leaf_readings(trg, tg),
        "port fp32 vs port fp64": _leaf_readings(
            {k: _np(v).astype(np.float64) for k, v in tg.items()}, g64),
        "reference fp32 vs port fp64": _leaf_readings(
            {k: _np(v).astype(np.float64) for k, v in jg.items()}, g64)}
    print(f"\nB {B}, {hw}x{hw}, layer4 BNs over {B * (hw // 32) ** 2} rows:")
    for what, (whole, leaf, worst, over) in readings.items():
        print(f"  {what}: relative L2 {whole:.4f} whole, {leaf:.4f} worst "
              f"leaf; worst leaf {worst:.4f} of its scale; {over} of "
              f"{len(jg)} leaves past {GRAD_TOL} of their scale")
    gap = readings["port vs reference"]
    noise = [a + b for a, b in zip(
        readings["reference vs itself, batch reversed"],
        readings["port vs itself, batch reversed"])]
    assert gap[0] <= 1.5 * noise[0] and gap[1] <= 1.5 * noise[1]
    assert readings["reference vs itself, batch reversed"][3] > len(jg) // 2


@pytest.mark.slow  # eight whole-model steps of each package; the fast
# sibling is test_resnet50_train_step_matches_reference
def test_resnet50_momentum_steps_overshoot_like_reference():
    """bench_resnet50's optimizer, Momentum(0.1, 0.9) without warm-up, on
    one repeated batch (B 16, 64x64, fp32, 1000 classes): in both packages
    the first update lowers the loss and a later one raises it above the
    start again, and none climbs to 3 times the start (the bound
    chip_smoke.py holds the card's b128 run to). The trajectories part
    after two steps (the net is chaotic, see above), so only that shape is
    held."""
    paddle.seed(0)
    jm = jresnet.resnet50(data_format="NHWC")
    tm = tresnet.resnet50(data_format="NHWC", device="cpu")
    load_numpy_params(tm, _export(jm))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 64, 64, 3)).astype(np.float32)
    y = rng.integers(0, 1000, 16).astype(np.int32)
    jst = JTrainStep(jm, JF.cross_entropy, jopt.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=jm.parameters()))
    tst = jit.TrainStep(tm, F.cross_entropy, optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=tm.parameters()))
    jl = [float(_np(jst(paddle.to_tensor(x), paddle.to_tensor(y))))
          for _ in range(8)]
    tl = [float(tst(torch.from_numpy(x), torch.from_numpy(
        y.astype(np.int64)))) for _ in range(8)]
    print("reference", jl, "\nport", tl)
    for losses in (jl, tl):
        assert losses[1] < losses[0] < max(losses[2:]) < 3 * losses[0]


def test_o2_train_step_keeps_buffers_fp32_and_advancing():
    """Under amp_dtype=bfloat16 the parameters (BN's gamma and beta
    included) and the images are cast, the running statistics stay fp32
    in the step's own buffers and move once a step."""
    tm = tresnet.resnet18(num_classes=4, data_format="NHWC", device="cpu")
    st = jit.TrainStep(tm, F.cross_entropy, optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=tm.parameters()),
        amp_dtype=torch.bfloat16)
    x, y = torch.randn(2, 32, 32, 3), torch.tensor([0, 3])
    seen = []
    for _ in range(2):
        before = st.buffers["bn1._mean"].clone()
        st(x, y)
        seen.append((st.buffers["bn1._mean"] - before).abs().max().item())
    assert all(s > 0 for s in seen)
    assert all(b.dtype == torch.float32 for b in st.buffers.values())
    assert all(p.dtype == torch.float32 for p in st.params.values())
    # the layer's own buffers move only when synced
    assert torch.equal(tm.bn1._mean, torch.zeros(64))
    st.sync_to_layer()
    assert torch.equal(tm.bn1._mean, st.buffers["bn1._mean"])


# ------------------------- weights, devices, options -------------------------


def test_load_numpy_params_round_trip_with_buffers():
    paddle.seed(1)
    jb = jresnet.BottleneckBlock(64, 16, data_format="NHWC")
    arrays = _export(jb)
    arrays["bn1._mean"] = np.arange(16, dtype=np.float32)
    tb = tresnet.BottleneckBlock(64, 16, data_format="NHWC", device="cpu")
    load_numpy_params(tb, arrays)
    back = {k: v.detach().numpy() for k, v in list(tb.named_parameters())
            + list(tb.named_buffers())}
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(KeyError):
        load_numpy_params(tb, {k: v for k, v in arrays.items()
                               if k != "bn2._variance"})


def test_load_train_state_restores_buffers():
    tm = tresnet.resnet18(num_classes=4, data_format="NHWC", device="cpu")
    st = jit.TrainStep(tm, F.cross_entropy, optimizer.Momentum(
        learning_rate=0.1, parameters=tm.parameters()))
    sd = st.state_dict()
    params = {k: v.detach().numpy() + 1 for k, v in st.params.items()}
    buffers = {k: v.numpy() + 2 for k, v in st.buffers.items()}
    load_train_state(st, sd, params, buffers)
    assert torch.equal(st.buffers["layer1.0.bn1._variance"],
                       torch.full((64,), 3.0))
    assert torch.equal(tm.layer1[0].bn1._variance, torch.full((64,), 3.0))
    np.testing.assert_array_equal(tm.conv1.weight.detach().numpy(),
                                  params["conv1.weight"])


def test_resnet_defaults_to_cuda_and_options(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tresnet.resnet50()
    with pytest.raises(RuntimeError):
        nn.BatchNorm2D(8)
    # per-stage remat builds (its parity with the reference is held in
    # tests/test_torch_long_context.py)
    assert tresnet.resnet18(recompute=True, device="cpu")._recompute
    with pytest.raises(ValueError):
        tresnet.resnet18(pretrained=True, device="cpu")
    m = tresnet.resnet18(num_classes=3, device="cpu")
    assert next(m.parameters()).device.type == "cpu"
    assert m.bn1._mean.device.type == "cpu"
    names = {k for k, _ in m.named_parameters()}
    assert {"conv1.weight", "layer2.0.downsample.0.weight",
            "layer2.0.downsample.1.weight", "fc.weight"} <= names
    assert m.layer2[0].downsample[1]._act is None
    assert m.fc.weight.param_name == "fc.weight"
