"""Fused training-mode BatchNorm(+residual add)+ReLU: the CUDA kernels
``csrc/fused_bn.cu``, their plain PyTorch versions, and the autograd
Function that carries them.

Replaces ``paddle_tpu/ops/pallas/fused_bn.py``'s three kernels over a
channels-last [R = N*H*W, C] view:

* ``_bn_act_fwd_pallas`` (l.93): ``y = act(x * k + c (+ z))`` with the
  per-channel fp32 ``k = gamma * inv`` and ``c = beta - mean * k``;
* ``_bn_bwd_reduce_pallas`` (l.150): ``dbeta = sum(g)`` and
  ``dgamma = sum(g * xhat)`` over the rows, with ``g = (y > 0) * dy`` (the
  ReLU mask from the saved output);
* ``_bn_bwd_dx_pallas`` (l.189): ``dx = A * g + B * x + C0`` and, for the
  add form, ``dz = g``.

All three are bound by bytes. See the source for the design. The batch
statistics of the forward are a torch reduction (``ops/_bn_common``), as
they are XLA in the reference; the per-channel ``A, B, C0`` of the
backward, with the mean/var cotangent terms, are a few fp32 vector ops
(``_bwd_common`` l.361-417).

Under a data-parallel group (``_bn_common.bn_scope``) the statistics are
the group's: between the launches, the forward all-reduces its moments
with the row count, and the backward the reduce kernel's column sums
(with the mean/var cotangents), so ``A, B, C0`` are the global batch's.
The kernels do not change.

The TPU's eligibility gates (R >= 256, R % 8, C % 128, C <= 2048, l.313-331)
were set by VMEM and the (8, 128) tiling; the H100 kernels take any R >= 1
and C >= 1, float32 or bfloat16, so every fused BN in those types takes
them. fp16 and fp64 compose on a card (``kernel_takes``), as they do in
the reference (l.327-328): the statistics, the folded affine and the plain
forward through autograd, counted in ``composed_stats``.
"""
from __future__ import annotations

import torch

from .. import _bn_common as _bnc
from . import checked, count_composed, launch, same_device, use_kernel

#: forward launches (and runs of its plain version)
_stats = {"kernel": 0, "plain": 0}
#: backward reduce launches
_reduce_stats = {"kernel": 0, "plain": 0}
#: backward dx launches
_dx_stats = {"kernel": 0, "plain": 0}

_TYPES = (torch.float32, torch.bfloat16)
#: rows a block of the reduce kernel walks, at least: the wrapper sizes the
#: kernel's fp32 partial sums [chunks, 2, C] with it (csrc/fused_bn.cu)
REDUCE_ROWS_PER_CHUNK = 128
REDUCE_MAX_CHUNKS = 512


def _relu_mask(g, y, act):
    return torch.where(y > 0, g, 0.0) if act == "relu" else g


def bn_act_fwd_plain(x2d, z2d, k, c, act):
    """act(x * k + c (+ z)) in fp32, written in x's type."""
    y = x2d.float() * k + c
    if z2d is not None:
        y = y + z2d.float()
    if act == "relu":
        y = torch.relu(y)
    return y.to(x2d.dtype)


def bn_bwd_reduce_plain(x2d, y2d, dy2d, mean, inv, act):
    """(dbeta, dgamma) fp32 [C]: column sums of g and g * xhat."""
    g = _relu_mask(dy2d.float(), y2d, act)
    xhat = (x2d.float() - mean) * inv
    return g.sum(0), (g * xhat).sum(0)


def bn_bwd_dx_plain(x2d, y2d, dy2d, a, b, c0, act, has_add):
    """(dx in x's type, dz = g in dy's type or None)."""
    g = _relu_mask(dy2d.float(), y2d, act)
    dx = (a * g + b * x2d.float() + c0).to(x2d.dtype)
    return dx, (g.to(dy2d.dtype) if has_add else None)


def kernel_takes(x, z=None) -> bool:
    """Whether the kernels take these row operands: x float32 or bfloat16,
    the residual z (if any) in x's type."""
    return x.dtype in _TYPES and (z is None or z.dtype == x.dtype)


def _check_rows(name, *tensors):
    """What the kernels take: contiguous [R, C] tensors of one type,
    float32 or bfloat16."""
    same_device(name, *tensors)
    x = tensors[0]
    for t in tensors:
        if t.dim() != 2 or t.shape != x.shape or not t.is_contiguous():
            raise ValueError(f"{name}: every row operand must be a "
                             f"contiguous [R, C] tensor of shape "
                             f"{tuple(x.shape)}, got {tuple(t.shape)}")
        if t.dtype != x.dtype:
            raise ValueError(f"{name}: mixed types {x.dtype} and {t.dtype}")
    if x.dtype not in _TYPES:
        raise ValueError(f"{name}: type {x.dtype}; the kernels take "
                         f"float32 and bfloat16")
    R, C = x.shape
    if not 1 <= C <= 65535 * 32 or R >= 2 ** 40:
        raise ValueError(f"{name}: R {R}, C {C} out of range")


def _check_channels(name, C, *vecs):
    for v in vecs:
        if v.dtype != torch.float32 or v.shape != (C,) \
                or not v.is_contiguous():
            raise ValueError(f"{name}: per-channel operands must be "
                             f"contiguous float32 [{C}], got {v.dtype} "
                             f"{tuple(v.shape)}")


def _is_relu(act):
    if act not in ("relu", None):
        raise ValueError(f"fused_bn: act {act!r}; only 'relu' and None")
    return int(act == "relu")


def bn_act_fwd(x2d, z2d, k, c, act):
    """y [R, C] in x's type = act(x * k + c (+ z))."""
    relu = _is_relu(act)
    if not use_kernel(x2d):
        _stats["plain"] += 1
        return bn_act_fwd_plain(x2d, z2d, k, c, act)
    rows = (x2d,) if z2d is None else (x2d, z2d)
    _check_rows("fused_bn_fwd", *rows)
    _check_channels("fused_bn_fwd", x2d.shape[1], k, c)
    same_device("fused_bn_fwd", x2d, k, c)
    y = torch.empty_like(x2d)
    R, C = x2d.shape
    if R == 0:
        return y
    launch("fused_bn_fwd", "pt_fused_bn_fwd", x2d.device,
           x2d.data_ptr(), 0 if z2d is None else z2d.data_ptr(),
           k.data_ptr(), c.data_ptr(), y.data_ptr(), R, C, relu,
           int(z2d is not None), int(x2d.dtype == torch.bfloat16))
    _stats["kernel"] += 1
    return y


def reduce_chunks(R: int) -> int:
    """Row chunks of the reduce kernel: one block row each, at least
    REDUCE_ROWS_PER_CHUNK rows, at most REDUCE_MAX_CHUNKS chunks."""
    return max(1, min(REDUCE_MAX_CHUNKS, -(-R // REDUCE_ROWS_PER_CHUNK)))


def bn_bwd_reduce(x2d, y2d, dy2d, mean, inv, act):
    """(dbeta, dgamma) fp32 [C] over all R rows."""
    relu = _is_relu(act)
    if not use_kernel(x2d):
        _reduce_stats["plain"] += 1
        return bn_bwd_reduce_plain(x2d, y2d, dy2d, mean, inv, act)
    _check_rows("fused_bn_bwd_reduce", x2d, y2d, dy2d)
    _check_channels("fused_bn_bwd_reduce", x2d.shape[1], mean, inv)
    same_device("fused_bn_bwd_reduce", x2d, mean, inv)
    R, C = x2d.shape
    if R == 0:
        out = torch.zeros(2, C, dtype=torch.float32, device=x2d.device)
        return out[0], out[1]
    out = torch.empty(2, C, dtype=torch.float32, device=x2d.device)
    chunks = reduce_chunks(R)
    part = torch.empty(chunks, 2, C, dtype=torch.float32, device=x2d.device)
    launch("fused_bn_bwd_reduce", "pt_fused_bn_bwd_reduce", x2d.device,
           x2d.data_ptr(), y2d.data_ptr(), dy2d.data_ptr(), mean.data_ptr(),
           inv.data_ptr(), part.data_ptr(), out.data_ptr(), R, C, chunks,
           relu, int(x2d.dtype == torch.bfloat16))
    _reduce_stats["kernel"] += 1
    return out[0], out[1]


def bn_bwd_dx(x2d, y2d, dy2d, a, b, c0, act, has_add):
    """(dx [R, C] in x's type, dz [R, C] = g or None)."""
    relu = _is_relu(act)
    if not use_kernel(x2d):
        _dx_stats["plain"] += 1
        return bn_bwd_dx_plain(x2d, y2d, dy2d, a, b, c0, act, has_add)
    _check_rows("fused_bn_bwd_dx", x2d, y2d, dy2d)
    _check_channels("fused_bn_bwd_dx", x2d.shape[1], a, b, c0)
    same_device("fused_bn_bwd_dx", x2d, a, b, c0)
    R, C = x2d.shape
    dx = torch.empty_like(x2d)
    dz = torch.empty_like(dy2d) if has_add else None
    if R == 0:
        return dx, dz
    launch("fused_bn_bwd_dx", "pt_fused_bn_bwd_dx", x2d.device,
           x2d.data_ptr(), y2d.data_ptr(), dy2d.data_ptr(), a.data_ptr(),
           b.data_ptr(), c0.data_ptr(), dx.data_ptr(),
           0 if dz is None else dz.data_ptr(), R, C, relu, int(has_add),
           int(x2d.dtype == torch.bfloat16))
    _dx_stats["kernel"] += 1
    return dx, dz


# ------------------------- forward / backward chain --------------------------


def fold_affine(gamma, beta, mean, inv):
    """Per-channel fp32 (k, c) with y = x * k + c."""
    k = inv * gamma.float()
    c = beta.float() - mean * k
    return k, c


def bwd_common(x2d, y2d, dy2d, gamma, beta, mean, inv, dmean, dvar, act,
               has_add, sync=None):
    """(dx, dz or None, dgamma, dbeta) of y = act(BN(x) (+ z)) over the
    [R, C] rows, the reference's ``_bwd_common``: the reduce kernel, the
    per-channel dx = A * g + B * x + C0 coefficients in fp32 (with the
    exact mean/var cotangent terms), then the dx kernel.

    With the forward's ``sync`` (``_bn_common.Sync``), the column sums and
    cotangents that form A, B and C0 are the group's
    (``_bn_common.group_sums``, one all-reduce). The returned dgamma and
    dbeta stay this rank's sums: the reducer (or TrainStep's buckets)
    averages them over the group."""
    n = x2d.shape[0]
    if dy2d is None:
        dy2d = torch.zeros_like(y2d)
    dy2d = dy2d.contiguous()
    db, dg = bn_bwd_reduce(x2d, y2d, dy2d, mean, inv, act)
    sdb, sdg, dmean, dvar = _bnc.group_sums(sync, db, dg, dmean, dvar)
    A = inv * gamma.float()
    B = -(A * inv * sdg) / n
    C0 = -(A * sdb) / n - B * mean
    if dvar is not None:
        dv = dvar.float()
        B = B + 2.0 * dv / n
        C0 = C0 - 2.0 * dv * mean / n
    if dmean is not None:
        C0 = C0 + dmean.float() / n
    dx, dz = bn_bwd_dx(x2d, y2d, dy2d, A.contiguous(), B.contiguous(),
                       C0.contiguous(), act, has_add)
    return dx, dz, dg.to(gamma.dtype), db.to(beta.dtype)


class FusedBNFunction(torch.autograd.Function):
    """(y, batch mean, batch var) of act(BN_train(x) (+ z)) over
    channels-last rows x [R, C] (z [R, C] or None); gradients flow to x,
    z, gamma and beta, and the mean/var cotangents fold into dx. With a
    data-parallel ``group`` the statistics and the backward's sums are
    the group's (kept from the forward: the backward looks up no scope)."""

    @staticmethod
    def forward(ctx, x2d, z2d, gamma, beta, epsilon, act, group=None):
        mean, var, ctx.sync = _bnc.group_stats(x2d, (0,), group)
        inv = torch.rsqrt(var + epsilon)
        k, c = fold_affine(gamma, beta, mean, inv)
        y = bn_act_fwd(x2d, z2d, k, c, act)
        ctx.save_for_backward(x2d, gamma, beta, mean, inv, y)
        ctx.act, ctx.has_add = act, z2d is not None
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x2d, gamma, beta, mean, inv, y = ctx.saved_tensors
        dx, dz, dgamma, dbeta = bwd_common(x2d, y, dy, gamma, beta, mean,
                                           inv, dmean, dvar, ctx.act,
                                           ctx.has_add, ctx.sync)
        return dx, dz, dgamma, dbeta, None, None, None


def _rows(t, channels_last):
    """[R, C] rows of t: a view for channels-last data, else a
    channels-last copy."""
    if not channels_last:
        t = t.movedim(1, -1)
    return t.reshape(-1, t.shape[-1]).contiguous()


def bn_act_composition(x2d, z2d, gamma, beta, epsilon, act, group=None):
    """(y, batch mean, batch var) of act(BN_train(x) (+ z)) as torch ops,
    differentiated by autograd: the arithmetic of FusedBNFunction's
    forward with the plain apply; with a ``group``, its statistics through
    the group's differentiable all-reduce."""
    _is_relu(act)
    mean, var = _bnc.group_stats_differentiable(x2d, (0,), group)
    k, c = fold_affine(gamma, beta, mean, torch.rsqrt(var + epsilon))
    return bn_act_fwd_plain(x2d, z2d, k, c, act), mean, var


def _fused(x, z, gamma, beta, epsilon, data_format, act):
    channels_last = not data_format.startswith("NC")
    z2d = None if z is None else _rows(z, channels_last)
    x2d = _rows(x, channels_last)
    group = _bnc.bn_group()
    if use_kernel(x2d) and not kernel_takes(x2d, z2d):
        count_composed("fused_bn")
        y2d, mean, var = bn_act_composition(x2d, z2d, gamma, beta, epsilon,
                                            act, group)
    else:
        y2d, mean, var = FusedBNFunction.apply(x2d, z2d, gamma, beta,
                                               epsilon, act, group)
    if channels_last:
        return y2d.reshape(x.shape), mean, var
    cl_shape = (x.shape[0], *x.shape[2:], x.shape[1])
    return y2d.reshape(cl_shape).movedim(-1, 1), mean, var


@checked("fused_bn_relu")
def fused_bn_relu(x, gamma, beta, *, epsilon=1e-5, data_format="NCHW",
                  act="relu"):
    """Training-mode BN + activation in one fused op: (y, batch_mean,
    batch_var), the statistics for the caller's running-stat update (the
    data-parallel group's under ``bn_group``). ``act`` is "relu" or
    None."""
    return _fused(x, None, gamma, beta, epsilon, data_format, act)


@checked("fused_bn_add_relu")
def fused_bn_add_relu(x, z, gamma, beta, *, epsilon=1e-5,
                      data_format="NCHW", act="relu"):
    """y = act(BN_train(x) + z), the ResNet block tail; gradients flow to
    x and the residual z."""
    return _fused(x, z, gamma, beta, epsilon, data_format, act)
