"""BatchNorm statistics shared by the unfused train path (``nn/functional``)
and the fused BN family (``ops/kernels/fused_bn``, ``fused_conv_bn``).

The port's own copy of ``paddle_tpu/ops/_bn_common.py``: one definition,
so the fused paths' running statistics agree with the unfused path's.
"""
from __future__ import annotations

import torch


def _bn_axes(x, data_format):
    """(axes reduced over, broadcast shape of a per-channel vector)."""
    c_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != c_axis)
    shape = [1] * x.dim()
    shape[c_axis] = x.shape[c_axis]
    return axes, shape


def _bn_stats(x, axes):
    """One-pass fp32 statistics: mean = E[x], var = E[x^2] - E[x]^2
    clamped at 0 (the reference's formula, l.22-30)."""
    xf = x.float()
    mean = xf.mean(dim=axes)
    mean2 = (xf * xf).mean(dim=axes)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    return mean, var
