"""Fused 1x1 conv + training-mode BatchNorm(+residual add)+ReLU: the CUDA
kernel ``csrc/fused_conv_bn.cu``, its plain PyTorch version, and the
autograd Function of the chain around it.

Replaces ``paddle_tpu/ops/pallas/fused_conv_bn.py``: ``_conv1x1_stats_pallas``
(l.103) computes a channels-last 1x1 convolution as the product
``y [R, Cout] = x [R, Cin] @ w`` and, in the same pass, the per-channel sum
and sum of squares of y as stored, so BN needs no separate read of y for
its statistics. The chain (l.277-422) is the conv with statistics, the
mean/var from the sums (``_stats_from_sums`` l.132), the apply pass through
the fused-BN forward kernel, and a backward that reuses the fused-BN reduce
and dx kernels and then forms ``dx = g @ w`` and ``dw = g^T @ x`` with
``torch.matmul`` (XLA matmuls in the reference, l.336-341).

The weight is the conv layer's (Cout, Cin, 1, 1), read as [Cout, Cin]
without a transpose (the reference reshapes it to [Cin, Cout]).

Designs (:func:`kernel_design`): a persistent warp-specialised kernel on
``wgmma`` fed by TMA loads (128-row output tiles, a ring of at least 4
stages, TMA stores of y), whose blocks each write one row of fp32 partial
sums: "wgmma-tma" for bf16, and "wgmma-3xtf32" for fp32, on the TF32
tensor cores with each product split as hi·hi + hi·lo + lo·hi (x split in
registers, w into two TF32 planes once a call, in scratch the wrapper
allocates), so fp32 keeps its accuracy. The wrapper allocates one row of
partials per 128-row tile (:func:`partial_rows`), the most the grid may
write; a second pass adds the rows written in a fixed order, so the sums
repeat bit for bit. Every shape :func:`check_args` admits runs its type's
design; there is no other.

:func:`eligible` is the port's own. The reference's gates (Cin, Cout % 128,
R >= 256, C <= 2048, on a TPU) were set by VMEM and the lane width; the
H100 kernel needs Cin and Cout to be multiples of 8 (16-byte rows of bf16)
and takes any R >= 1, so every stride-1 1x1 conv of ResNet-50's
bottlenecks takes it (32 a step, where the TPU's gate admits 26).

Under a data-parallel group (``_bn_common.bn_scope``) the epilogue's
moments are all-reduced with the row count before the fold, and the
backward is the fused BN's grouped one (``fused_bn.bwd_common``).
"""
from __future__ import annotations

import torch

from .. import _bn_common as _bnc
from . import fused_bn as _fbn
from . import checked, count_design, launch, same_device, use_kernel

#: conv1x1-with-statistics launches (and runs of its plain version)
_stats = {"kernel": 0, "plain": 0}

_TYPES = (torch.float32, torch.bfloat16)
#: rows of y an output tile holds, by type (csrc/fused_conv_bn.cu kWgBM)
TILE_ROWS = {torch.bfloat16: 128, torch.float32: 128}
#: the design of each type (csrc/fused_conv_bn.cu)
DESIGNS = {torch.bfloat16: "wgmma-tma", torch.float32: "wgmma-3xtf32"}


def kernel_design(x2d) -> str:
    """The design the launcher runs: "wgmma-tma" for bf16, "wgmma-3xtf32"
    (the TF32 tensor cores in a 3xTF32 split) for fp32."""
    return DESIGNS[x2d.dtype]


def partial_rows(R: int, dtype) -> int:
    """Rows of fp32 partial sums [rows, 2, Cout] the wrapper allocates
    for R rows of x: one per 128-row output tile. Each block of the
    persistent grid writes one, and the launcher sizes the grid from the
    card's SM count, at most one block a tile; it adds only the rows it
    wrote."""
    return -(-R // TILE_ROWS[dtype])


def conv1x1_stats_plain(x2d, w2d):
    """(y [R, Cout] in x's type, sum, sumsq fp32 [Cout]) of y = x @ w^T,
    the sums over y as stored."""
    y = (x2d.float() @ w2d.float().t()).to(x2d.dtype)
    yc = y.float()
    return y, yc.sum(0), (yc * yc).sum(0)


def check_args(x2d, w2d) -> None:
    """What the CUDA kernel takes; raises ValueError on anything else."""
    same_device("conv1x1_stats", x2d, w2d)
    if x2d.dim() != 2 or w2d.dim() != 2 or x2d.shape[1] != w2d.shape[1]:
        raise ValueError(f"conv1x1_stats: x [R, Cin] and w [Cout, Cin], got "
                         f"{tuple(x2d.shape)} and {tuple(w2d.shape)}")
    if not (x2d.is_contiguous() and w2d.is_contiguous()):
        raise ValueError("conv1x1_stats: x and w must be contiguous")
    if x2d.dtype not in _TYPES or w2d.dtype != x2d.dtype:
        raise ValueError(f"conv1x1_stats: types {x2d.dtype}, {w2d.dtype}; "
                         f"the kernel takes float32 or bfloat16, both alike")
    Cout, Cin = w2d.shape
    if Cin % 8 or Cout % 8:
        raise ValueError(f"conv1x1_stats: Cin {Cin} and Cout {Cout} must be "
                         f"multiples of 8")
    if x2d.data_ptr() % 16 or w2d.data_ptr() % 16:
        raise ValueError("conv1x1_stats: x and w must be 16-byte aligned")


def conv1x1_stats(x2d, w2d):
    """(y [R, Cout], sum [Cout], sumsq [Cout]) in one pass over x."""
    if not use_kernel(x2d):
        _stats["plain"] += 1
        return conv1x1_stats_plain(x2d, w2d)
    check_args(x2d, w2d)
    R = x2d.shape[0]
    Cout = w2d.shape[0]
    y = torch.empty(R, Cout, dtype=x2d.dtype, device=x2d.device)
    if R == 0:
        z = torch.zeros(Cout, dtype=torch.float32, device=x2d.device)
        return y, z, z.clone()
    tiles = partial_rows(R, x2d.dtype)
    part = torch.empty(tiles, 2, Cout, dtype=torch.float32,
                       device=x2d.device)
    # fp32: w's two TF32 planes (hi, lo), split by the launcher
    wsplit = (None if x2d.dtype == torch.bfloat16 else
              torch.empty(2, *w2d.shape, dtype=torch.float32,
                          device=x2d.device))
    out = torch.empty(2, Cout, dtype=torch.float32, device=x2d.device)
    launch("conv1x1_stats", "pt_conv1x1_stats", x2d.device, x2d.data_ptr(),
           w2d.data_ptr(), y.data_ptr(), part.data_ptr(),
           None if wsplit is None else wsplit.data_ptr(), out.data_ptr(), R,
           x2d.shape[1], Cout, tiles, int(x2d.dtype == torch.bfloat16))
    _stats["kernel"] += 1
    count_design("conv1x1_stats", kernel_design(x2d),
                 f"R={R} Cin={x2d.shape[1]} Cout={Cout}")
    return y, out[0], out[1]


def stats_from_sums(s, ss, R: int, group=None):
    """(mean, var, sync) from the epilogue sums: E[y], E[y^2] - E[y]^2
    clamped at 0, the formula of ``ops/_bn_common._bn_stats``; with a
    ``group``, of the group's batch (``_bn_common.group_moments``; sync
    as there, else None)."""
    mean, mean2, sync = s / R, ss / R, None
    if group is not None:
        mean, mean2, sync = _bnc.group_moments(mean, mean2, R, group)
    return mean, _bnc._var(mean, mean2), sync


class Conv1x1BNFunction(torch.autograd.Function):
    """(y, batch mean, batch var) of act(BN_train(x @ w^T) (+ z)) over
    channels-last rows x [R, Cin], w [Cout, Cin], z [R, Cout] or None;
    with a data-parallel ``group``, the group's statistics and backward
    sums (the group kept from the forward)."""

    @staticmethod
    def forward(ctx, x2d, z2d, w2d, gamma, beta, epsilon, act, group=None):
        y_conv, s, ss = conv1x1_stats(x2d, w2d)
        mean, var, ctx.sync = stats_from_sums(s, ss, x2d.shape[0], group)
        inv = torch.rsqrt(var + epsilon)
        k, c = _fbn.fold_affine(gamma, beta, mean, inv)
        y = _fbn.bn_act_fwd(y_conv, z2d, k, c, act)
        ctx.save_for_backward(x2d, w2d, gamma, beta, mean, inv, y_conv, y)
        ctx.act, ctx.has_add = act, z2d is not None
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x2d, w2d, gamma, beta, mean, inv, y_conv, y = ctx.saved_tensors
        g, dz, dgamma, dbeta = _fbn.bwd_common(
            y_conv, y, dy, gamma, beta, mean, inv, dmean, dvar, ctx.act,
            ctx.has_add, ctx.sync)
        dx = torch.matmul(g, w2d)
        dw = torch.matmul(g.t(), x2d)
        return dx, dz, dw, dgamma, dbeta, None, None, None


def _all_ones(v):
    return all(int(s) == 1 for s in (v if isinstance(v, (tuple, list))
                                     else (v,)))


def _no_padding(v):
    if isinstance(v, str):
        return v.upper() == "VALID"
    return all(int(s) == 0 for s in (v if isinstance(v, (tuple, list))
                                     else (v,)))


def eligible(x_shape, w_shape, stride, padding, dilation, groups,
             data_format: str, dtype) -> bool:
    """Can this conv + training BN take the fused chain: a channels-last
    [N, H, W, Cin] input, a (Cout, Cin, 1, 1) weight with stride 1, no
    padding, no dilation and one group, Cin and Cout multiples of 8, float32
    or bfloat16. Every device: the CPU runs the same chain on the plain
    versions."""
    if data_format.startswith("NC") or len(x_shape) != 4:
        return False
    if len(w_shape) != 4 or tuple(w_shape[2:]) != (1, 1):
        return False
    if not (_all_ones(stride) and _all_ones(dilation) and groups == 1
            and _no_padding(padding)):
        return False
    Cout, Cin = int(w_shape[0]), int(w_shape[1])
    if int(x_shape[3]) != Cin or Cin % 8 or Cout % 8:
        return False
    return dtype in _TYPES


@checked("fused_conv1x1_bn_act")
def fused_conv1x1_bn_act(x, w, gamma, beta, *, residual=None, epsilon=1e-5,
                         act="relu"):
    """Training-mode ``act(BN(conv1x1(x)) [+ residual])`` over channels-last
    ``x [N, H, W, Cin]`` and the (Cout, Cin, 1, 1) weight ``w``: (y [N, H,
    W, Cout], batch_mean, batch_var), the statistics the data-parallel
    group's under ``bn_group``. Callers check :func:`eligible`."""
    N, H, W, Cin = x.shape
    Cout = w.shape[0]
    w2d = w.reshape(Cout, Cin).to(x.dtype).contiguous()
    x2d = x.reshape(-1, Cin).contiguous()
    z2d = None if residual is None else residual.reshape(-1, Cout).contiguous()
    y, mean, var = Conv1x1BNFunction.apply(x2d, z2d, w2d, gamma, beta,
                                           epsilon, act, _bnc.bn_group())
    return y.reshape(N, H, W, Cout), mean, var
