"""Layer norm: the forward's and the backward's CUDA kernels
``csrc/layer_norm.cu``, their plain PyTorch versions, and the autograd
Function that carries them.

Replaces ``paddle_tpu/ops/pallas/layer_norm.py:_ln_fwd_pallas`` (the
TPU row-block kernel) and ``_fused_ln_bwd`` (l.193), the backward that
XLA fuses into one loop on the TPU. Both kernels are bound by bytes; one
warp a row, the row held in registers through 16-byte loads, fp32 sums,
and the TPU's variance formula var = E[x^2] - mean^2 so both match the
reference. They take any R >= 1 and any N: the TPU-shaped eligibility
(R >= 256, N % 128 == 0, N <= 4096) does not carry over, so decode rows
(R <= 32) run the kernel too. See the source for the design.

``fused_layer_norm`` is one ``torch.autograd.Function`` on both devices
(counterpart of the ``jax.custom_vjp`` at ``layer_norm.py:178``): its
forward launches the forward kernel and its backward ``layer_norm_bwd``,
the backward kernel (on the CPU the plain versions: ``layer_norm_plain``
and ``layer_norm_bwd_plain``, the torch composition of ``_fused_ln_bwd``).
The backward keeps only ``(x, gamma)`` and recomputes mean and rstd.
Types the kernels do not take (fp16, fp64, beta in another type than
gamma; ``kernel_takes``) compose on a card, as XLA composes them in the
reference (l.159-173): the plain forward through autograd, counted in
``composed_stats``.

``fused_residual_dropout_ln`` is the residual + dropout + layer-norm
epilogue of the fused transformer layers (reference l.215), composed
around the same Function.
"""
from __future__ import annotations

import torch

from ...framework import random as _random
from . import checked, count_composed, launch, same_device, use_kernel

_stats = {"kernel": 0, "plain": 0}
_bwd_stats = {"kernel": 0, "plain": 0}

_TYPES = (torch.float32, torch.bfloat16)

#: most rows of fp32 partial column sums [rows, 2N] the backward's wrapper
#: allocates, and most fp32 values in them: the kernel's persistent grid
#: writes one row a block, no more blocks than fit on the card at once
#: nor than the rows allocated
BWD_MAX_PARTS = 1024
BWD_MAX_PART_VALUES = 1 << 22


def bwd_parts(R: int, N: int) -> int:
    """Rows of partial column sums the backward's wrapper allocates for x
    [R, N]: at most one a row of x, BWD_MAX_PARTS, and 16 MiB in all."""
    return min(R, BWD_MAX_PARTS, max(1, BWD_MAX_PART_VALUES // (2 * N)))


def layer_norm_plain(x2d, gamma, beta, eps: float = 1e-5):
    """y = (x - mean) * rsqrt(var + eps) * gamma + beta over the last dim,
    in fp32 with var = E[x^2] - mean^2, written in x's type."""
    xf = x2d.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x2d.dtype)


def kernel_takes(x, gamma, beta) -> bool:
    """Whether the kernel takes these types: x and gamma float32 or
    bfloat16, beta in gamma's type."""
    return (x.dtype in _TYPES and gamma.dtype in _TYPES
            and beta.dtype == gamma.dtype)


def check_args(x2d, gamma, beta) -> None:
    """What the CUDA kernel takes; raises ValueError on anything else."""
    same_device("layer_norm", x2d, gamma, beta)
    if x2d.dim() != 2 or not x2d.is_contiguous():
        raise ValueError("layer_norm: x must be a contiguous [R, N] tensor")
    if x2d.dtype not in _TYPES or gamma.dtype not in _TYPES:
        raise ValueError(f"layer_norm: types {x2d.dtype}/{gamma.dtype}; "
                         f"the kernel takes float32 and bfloat16")
    if beta.dtype != gamma.dtype:
        raise ValueError("layer_norm: gamma and beta must share a type")
    n = x2d.shape[1]
    for t in (gamma, beta):
        if t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f"layer_norm: gamma/beta must be contiguous "
                             f"[{n}], got {tuple(t.shape)}")


def layer_norm_fwd(x2d, gamma, beta, eps: float = 1e-5):
    """Layer norm of each row of ``x2d`` [R, N]."""
    if not use_kernel(x2d):
        _stats["plain"] += 1
        return layer_norm_plain(x2d, gamma, beta, eps)
    check_args(x2d, gamma, beta)
    y = torch.empty_like(x2d)
    R, N = x2d.shape
    if R == 0:
        return y
    launch("layer_norm", "pt_layer_norm_fwd", x2d.device,
           x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
           R, N, float(eps), int(x2d.dtype == torch.bfloat16),
           int(gamma.dtype == torch.bfloat16))
    _stats["kernel"] += 1
    return y


def layer_norm_bwd_plain(x2d, gamma, dy2d, eps: float = 1e-5):
    """(dx, dgamma, dbeta) of the layer norm of ``x2d`` [R, N], computed in
    fp32 from recomputed statistics; dx in x's type, dgamma and dbeta in
    gamma's (as ``_fused_ln_bwd`` returns them, so the O2 rounding
    matches)."""
    xf = x2d.float()
    dyf = dy2d.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    dg = (dyf * xhat).sum(dim=0).to(gamma.dtype)
    db = dyf.sum(dim=0).to(gamma.dtype)
    dxhat = dyf * gamma.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (dxhat - m1 - xhat * m2)).to(x2d.dtype)
    return dx, dg, db


def check_bwd_args(x2d, gamma, dy2d) -> None:
    """What the backward kernel takes; raises ValueError on anything
    else."""
    same_device("layer_norm_bwd", x2d, gamma, dy2d)
    if x2d.dim() != 2 or not x2d.is_contiguous():
        raise ValueError("layer_norm_bwd: x must be a contiguous [R, N] "
                         "tensor")
    if (dy2d.shape != x2d.shape or dy2d.dtype != x2d.dtype
            or not dy2d.is_contiguous()):
        raise ValueError(f"layer_norm_bwd: dy must be contiguous "
                         f"{tuple(x2d.shape)} {x2d.dtype}, got "
                         f"{tuple(dy2d.shape)} {dy2d.dtype}")
    if x2d.dtype not in _TYPES or gamma.dtype not in _TYPES:
        raise ValueError(f"layer_norm_bwd: types {x2d.dtype}/{gamma.dtype}; "
                         f"the kernel takes float32 and bfloat16")
    n = x2d.shape[1]
    if gamma.shape != (n,) or not gamma.is_contiguous():
        raise ValueError(f"layer_norm_bwd: gamma must be contiguous [{n}], "
                         f"got {tuple(gamma.shape)}")


def layer_norm_bwd(x2d, gamma, dy2d, eps: float = 1e-5):
    """(dx, dgamma, dbeta) of the layer norm of ``x2d`` [R, N] for the
    output's gradient ``dy2d``, as ``layer_norm_bwd_plain`` computes them:
    the kernel on a card (R = 0 gives zero dgamma and dbeta), the plain
    version on the CPU."""
    if not use_kernel(x2d):
        _bwd_stats["plain"] += 1
        return layer_norm_bwd_plain(x2d, gamma, dy2d, eps)
    check_bwd_args(x2d, gamma, dy2d)
    R, N = x2d.shape
    dev = x2d.device
    dx = torch.empty_like(x2d)
    dgb = torch.empty(2, N, dtype=gamma.dtype, device=dev)
    parts = bwd_parts(R, N)
    part = torch.empty(parts, 2 * N, dtype=torch.float32, device=dev)
    launch("layer_norm_bwd", "pt_layer_norm_bwd", dev, x2d.data_ptr(),
           dy2d.data_ptr(), gamma.data_ptr(), dx.data_ptr(), part.data_ptr(),
           dgb.data_ptr(), R, N, parts, float(eps),
           int(x2d.dtype == torch.bfloat16),
           int(gamma.dtype == torch.bfloat16))
    _bwd_stats["kernel"] += 1
    return dx, dgb[0], dgb[1]


class LayerNormFunction(torch.autograd.Function):
    """Layer norm over the last dim of x (any leading shape): the forward
    and backward kernels (their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        shape = x.shape
        x2d = x.reshape(-1, shape[-1]).contiguous()
        ctx.save_for_backward(x2d, gamma)
        ctx.eps = eps
        return layer_norm_fwd(x2d, gamma, beta, eps).reshape(shape)

    @staticmethod
    def backward(ctx, dy):
        x2d, gamma = ctx.saved_tensors
        dx, dg, db = layer_norm_bwd(x2d, gamma,
                                    dy.contiguous().view(x2d.shape), ctx.eps)
        return dx.reshape(dy.shape), dg, db, None


@checked("layer_norm")
def fused_layer_norm(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last dim of x (any leading shape): the Function,
    or on a card the composition for types the kernel does not take."""
    if use_kernel(x) and not kernel_takes(x, gamma, beta):
        count_composed("layer_norm")
        return layer_norm_plain(x.reshape(-1, x.shape[-1]), gamma, beta,
                                float(eps)).reshape(x.shape)
    return LayerNormFunction.apply(x, gamma, beta, float(eps))


def fused_residual_dropout_ln(x, residual, gamma, beta, *, p: float = 0.0,
                              eps: float = 1e-5, generator=None,
                              training: bool = True):
    """LN(residual + dropout(x)): the upscale-in-train dropout of x (kept
    values divided by 1 - p), the residual add, then ``fused_layer_norm``
    (its kernel on a card)."""
    if training and p > 0.0:
        keep = _random.rand(x.shape, generator, x.device) >= p
        x = torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return fused_layer_norm(residual + x, gamma, beta, eps)
