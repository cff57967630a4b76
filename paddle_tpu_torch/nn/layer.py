"""``Layer`` as a ``torch.nn.Module`` (counterpart of
``paddle_tpu/nn/layer.py``).

Sub-layers and parameters are attributes, so ``named_parameters`` and
``state_dict`` give paddle's names (``blocks.0.attn.qkv.weight``) and
``eval()`` switches dropout off, all as ``nn.Module`` does. What ``Layer``
adds is parameter creation: initial values are drawn on the CPU from an
explicit ``torch.Generator`` (PyTorch's default one when none is given),
so a seed gives the same weights on every device, and then moved to the
layer's device.
"""
from __future__ import annotations

import math

import torch

from .._platform import resolve_device
from ..framework.dtype import convert_dtype


def xavier_uniform(shape, generator=None) -> torch.Tensor:
    """paddle's XavierUniform: U(-a, a), a = sqrt(6 / (fan_in + fan_out)),
    with fan_in = shape[0] and fan_out = shape[1] for a 2-D weight."""
    fan_in, fan_out = shape[0], shape[1]
    a = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-a, a, generator=generator)


class Layer(torch.nn.Module):
    """Base of the port's layers: an ``nn.Module`` that builds its
    parameters on ``device`` (``cuda`` unless the caller says otherwise)."""

    def __init__(self, device=None, dtype=None):
        super().__init__()
        self._device = resolve_device(device)
        self._dtype = convert_dtype(dtype) or torch.float32

    def create_parameter(self, value: torch.Tensor) -> torch.nn.Parameter:
        """A parameter holding ``value`` (made on the CPU), moved to this
        layer's device and type."""
        return torch.nn.Parameter(
            value.to(device=self._device, dtype=self._dtype))
