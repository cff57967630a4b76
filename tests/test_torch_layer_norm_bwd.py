"""The layer norm's backward in the port (paddle_tpu_torch/ops/kernels/
layer_norm.py) against the JAX package's ``_fused_ln_bwd``.

On a card ``layer_norm_bwd`` launches the kernel of ``csrc/layer_norm.cu``
(held against ``layer_norm_bwd_plain`` by chip_smoke.py); here, on the
CPU, it runs ``layer_norm_bwd_plain``, the torch composition, which is
held against ``jax.grad`` of the reference's custom-vjp
``fused_layer_norm`` (whose backward is ``_fused_ln_bwd``). The same
numpy inputs, made from a seed, go to both; dy is rounded to x's type on
both sides, as the cotangent of y arrives in y's type.

Tolerances: both compute in fp32 and sum in another order, so an fp32
output agrees within 2e-5 of max(1, max |reference|); an output in
bfloat16 is the same fp32 value rounded once in each package, so it may
also differ by one bf16 unit in the last place (2^-7 of its magnitude).
The card's route (argument checks, the launch, the Function's wiring) is
exercised by monkeypatching ``use_kernel`` to True and ``launch`` to
record its arguments.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import layer_norm as jln
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import layer_norm as ln

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ATOL = 2e-5
BF16_ULP = 2.0 ** -7


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _pair(a, dtype):
    a = np.asarray(a, np.float32)
    return (jnp.asarray(a).astype(jnp.dtype(dtype)),
            torch.from_numpy(a).to(TDT[dtype]))


def _held(got, want, dtype):
    """got within ATOL of max(1, max |want|), plus one bf16 unit of |want|
    where the output is bfloat16; NaN where want is NaN."""
    got, want = _np(got), _np(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    tol = ATOL * max(1.0, float(np.abs(want[ok]).max(initial=0.0)))
    if dtype == "bfloat16":
        tol = tol + BF16_ULP * np.abs(want[ok])
    assert np.all(np.abs(got[ok] - want[ok]) <= tol), float(
        np.abs(got[ok] - want[ok]).max(initial=0.0))


def _reference(x, g, b, dy, eps):
    """(dx, dgamma, dbeta) of jax.grad through the reference's custom vjp:
    the cotangent of y is dy (already in y's type)."""
    def f(x_, g_, b_):
        y = jln.fused_layer_norm(x_, g_, b_, eps)
        return jnp.sum(y.astype(jnp.float32) * dy.astype(jnp.float32))
    return jax.grad(f, argnums=(0, 1, 2))(x, g, b)


def _inputs(seed, R, N, xdt, gdt):
    rng = np.random.default_rng(seed)
    x = _pair(1.0 + rng.normal(size=(R, N)), xdt)
    g = _pair(1.0 + 0.1 * rng.normal(size=N), gdt)
    b = _pair(0.1 * rng.normal(size=N), gdt)
    dy = _pair(rng.normal(size=(R, N)), xdt)
    return x, g, b, dy


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
@pytest.mark.parametrize("xdt,gdt", [("float32", "float32"),
                                     ("float32", "bfloat16"),
                                     ("bfloat16", "float32"),
                                     ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("N", [7, 48, 512, 768])
@pytest.mark.parametrize("R", [1, 5, 64])
def test_plain_matches_reference_backward(R, N, xdt, gdt, eps):
    (jx, tx), (jg, tg), (jb, _), (jdy, tdy) = _inputs(R * N, R, N, xdt, gdt)
    want = _reference(jx, jg, jb, jdy, eps)
    got = ln.layer_norm_bwd_plain(tx, tg, tdy, eps)
    assert got[0].dtype == TDT[xdt]
    assert got[1].dtype == got[2].dtype == TDT[gdt]
    for gt, w, dt in zip(got, want, (xdt, gdt, gdt)):
        assert tuple(gt.shape) == tuple(w.shape)
        _held(gt, w, dt)


@pytest.mark.parametrize("where", ["x", "dy"])
def test_plain_keeps_the_references_nans(where):
    """A NaN in one row of x gives NaN in that row's dx and in every
    dgamma column; one in dy in that row's dx and in its column of dgamma
    and dbeta: the same places as the reference's."""
    (jx, tx), (jg, tg), (jb, _), (jdy, tdy) = _inputs(3, 6, 48, "float32",
                                                      "float32")
    if where == "x":
        jx, tx = jx.at[2, 5].set(jnp.nan), tx.clone()
        tx[2, 5] = float("nan")
    else:
        jdy, tdy = jdy.at[4, 9].set(jnp.nan), tdy.clone()
        tdy[4, 9] = float("nan")
    want = _reference(jx, jg, jb, jdy, 1e-5)
    got = ln.layer_norm_bwd_plain(tx, tg, tdy, 1e-5)
    for gt, w in zip(got, want):
        _held(gt, w, "float32")
    row = 2 if where == "x" else 4
    assert torch.isnan(got[0][row]).all()
    assert not torch.isnan(got[0][row + 1]).any()


def test_plain_zero_rows():
    x = torch.empty(0, 16)
    dx, dg, db = ln.layer_norm_bwd_plain(x, torch.ones(16), x)
    assert dx.shape == (0, 16)
    assert torch.equal(dg, torch.zeros(16)) and torch.equal(db, dg)


@pytest.mark.parametrize("case", ["strided_x", "strided_dy", "dy_shape",
                                  "dy_type", "fp16", "fp64_gamma",
                                  "gamma_shape", "strided_gamma", "rank",
                                  "device"])
def test_check_bwd_args_raises(case):
    x, g, dy = torch.ones(4, 8), torch.ones(8), torch.ones(4, 8)
    if case == "strided_x":
        x = torch.ones(8, 4).t()
    elif case == "strided_dy":
        dy = torch.ones(8, 4).t()
    elif case == "dy_shape":
        dy = torch.ones(4, 9)
    elif case == "dy_type":
        dy = dy.bfloat16()
    elif case == "fp16":
        x, dy = x.half(), dy.half()
    elif case == "fp64_gamma":
        g = g.double()
    elif case == "gamma_shape":
        g = torch.ones(7)
    elif case == "strided_gamma":
        g = torch.ones(16)[::2]
    elif case == "rank":
        x, dy = torch.ones(2, 2, 8), torch.ones(2, 2, 8)
    else:
        g = torch.ones(8, device="meta")
    with pytest.raises(ValueError):
        ln.check_bwd_args(x, g, dy)
    ln.check_bwd_args(torch.ones(4, 8), torch.ones(8), torch.ones(4, 8))
    ln.check_bwd_args(torch.ones(4, 8).bfloat16(), torch.ones(8),
                      torch.ones(4, 8).bfloat16())


@pytest.mark.parametrize("R,N,want", [(0, 768, 0), (5, 768, 5),
                                       (50000, 768, 1024),
                                       (50000, 8192, 256),
                                       (3, 1 << 22, 1)])
def test_bwd_parts(R, N, want):
    """The partial-row scratch: one row a row of x at most, 1,024 rows,
    and 16 MiB of fp32 (but one row however wide N is)."""
    assert ln.bwd_parts(R, N) == want


def test_cpu_counts_plain():
    kernels.reset_stats()
    x = torch.randn(4, 8)
    dx, dg, db = ln.layer_norm_bwd(x, torch.ones(8), torch.randn(4, 8))
    assert kernels.all_stats()["layer_norm_bwd"] == {"kernel": 0, "plain": 1}
    assert kernels.all_stats()["layer_norm"] == {"kernel": 0, "plain": 0}
    x.requires_grad_(True)
    ln.fused_layer_norm(x, torch.ones(8), torch.zeros(8)).sum().backward()
    assert kernels.all_stats()["layer_norm_bwd"] == {"kernel": 0, "plain": 2}
    assert kernels.all_stats()["layer_norm"] == {"kernel": 0, "plain": 1}


def test_function_backward_goes_through_layer_norm_bwd(monkeypatch):
    """Guard: the Function's backward calls ``layer_norm_bwd`` with a
    contiguous dy, so a non-contiguous output gradient (a transposed
    view) gives the gradients a contiguous one gives."""
    seen = []
    orig = ln.layer_norm_bwd

    def spy(x2d, gamma, dy2d, eps):
        seen.append((tuple(x2d.shape), dy2d.is_contiguous(), eps))
        return orig(x2d, gamma, dy2d, eps)

    monkeypatch.setattr(ln, "layer_norm_bwd", spy)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(3, 5, 16)).astype(np.float32))
    g = torch.from_numpy(1 + 0.1 * rng.normal(size=16).astype(np.float32))
    b = torch.zeros(16)
    leaves = [t.clone().requires_grad_(True) for t in (x, g, b)]
    y = ln.fused_layer_norm(*leaves, 1e-6)
    dy_t = torch.from_numpy(rng.normal(size=(16, 5, 3)).astype(
        np.float32)).permute(2, 1, 0)
    assert not dy_t.is_contiguous()
    got = torch.autograd.grad(y, leaves, dy_t, retain_graph=True)
    want = torch.autograd.grad(y, leaves, dy_t.contiguous())
    assert seen == [((15, 16), True, 1e-6)] * 2
    for a, w in zip(got, want):
        assert torch.equal(a, w)


class _Launched(RuntimeError):
    pass


@pytest.mark.parametrize("R", [0, 6, 3000])
@pytest.mark.parametrize("xdt,gdt", [("float32", "float32"),
                                     ("bfloat16", "float32"),
                                     ("bfloat16", "bfloat16")])
def test_card_route_launches_the_backward_kernel(R, xdt, gdt, monkeypatch):
    """On the card's route the Function's backward reaches the kernel's
    entry with a contiguous dy from a non-contiguous one, its partial-row
    scratch [bwd_parts(R, N), 2N] fp32, and the type flags; no
    plain version runs and nothing composes."""
    calls = []

    def launch(name, entry, device, *args):
        calls.append((name, entry, args))
        if entry == "pt_layer_norm_bwd":
            raise _Launched(name)

    monkeypatch.setattr(ln, "use_kernel", lambda t: True)
    monkeypatch.setattr(ln, "launch", launch)
    N = 24
    x = torch.randn(R, N).to(TDT[xdt]).requires_grad_(True)
    g = torch.ones(N, dtype=TDT[gdt], requires_grad=True)
    b = torch.zeros(N, dtype=TDT[gdt], requires_grad=True)
    y = ln.fused_layer_norm(x, g, b, 1e-5)
    dy = torch.randn(N, R).to(TDT[xdt]).t()
    kernels.reset_stats()
    with pytest.raises(_Launched, match="layer_norm_bwd"):
        torch.autograd.grad(y, (x, g, b), dy)
    entries = [c[1] for c in calls]
    assert entries[-1] == "pt_layer_norm_bwd"
    args = calls[-1][2]
    rows, n, parts, eps, x_bf16, w_bf16 = args[6:]
    assert (rows, n, parts, eps) == (R, N, min(R, ln.BWD_MAX_PARTS), 1e-5)
    assert parts == ln.bwd_parts(R, N)
    assert (x_bf16, w_bf16) == (int(xdt == "bfloat16"),
                                int(gdt == "bfloat16"))
    assert kernels.all_stats()["layer_norm_bwd"] == {"kernel": 0, "plain": 0}
    assert not any(kernels.composed_stats().values())
