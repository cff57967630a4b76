"""Layer-norm forward: CUDA kernel ``csrc/layer_norm.cu`` and its plain
PyTorch version.

Replaces ``paddle_tpu/ops/pallas/layer_norm.py:_ln_fwd_pallas`` (the TPU
row-block kernel). The kernel is bound by bytes; one warp per row, fp32
sums, and the TPU's variance formula var = E[x^2] - mean^2 so both match
the reference. It takes any R >= 1 and any N: the TPU-shaped eligibility
(R >= 256, N % 128 == 0, N <= 4096) does not carry over, so decode rows
(R <= 32) run the kernel too. See the source for the design.

Only the forward is ported: the serving path needs no backward.
"""
from __future__ import annotations

import torch

from . import launch, same_device, use_kernel

_stats = {"kernel": 0, "plain": 0}

_TYPES = (torch.float32, torch.bfloat16)


def layer_norm_plain(x2d, gamma, beta, eps: float = 1e-5):
    """y = (x - mean) * rsqrt(var + eps) * gamma + beta over the last dim,
    in fp32 with var = E[x^2] - mean^2, written in x's type."""
    xf = x2d.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x2d.dtype)


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


def fused_layer_norm(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last dim of x (any leading shape)."""
    shape = x.shape
    y = layer_norm_fwd(x.reshape(-1, shape[-1]).contiguous(), gamma, beta,
                       eps)
    return y.reshape(shape)
