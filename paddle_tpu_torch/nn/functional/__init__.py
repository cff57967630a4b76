"""The functionals of the serving slice (counterpart of
``paddle_tpu/nn/functional/__init__.py``): ``linear`` (l.228),
``embedding`` (l.244), ``gelu`` (l.80), ``dropout`` (l.270),
``layer_norm`` (l.534) and ``scaled_dot_product_attention`` (l.1285).

Layer norm and attention go to the hand-written kernels of
``ops/kernels`` (on a CUDA tensor) or their plain versions (on a CPU
tensor). The large matrix products stay with ``torch.matmul``, as the
JAX package left them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as _tF

from ...ops.kernels import flash_attention as _fa
from ...ops.kernels import layer_norm as _ln

__all__ = ["linear", "embedding", "gelu", "dropout", "layer_norm",
           "scaled_dot_product_attention"]


def linear(x, weight, bias=None):
    """x @ weight + bias, with paddle's [in, out] weight layout."""
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def embedding(x, weight):
    """Rows of ``weight`` at the indices ``x``. The reference's ``take``
    fills an out-of-range index silently; here it raises (on a card, as a
    device-side assert), so callers pass valid ids."""
    return _tF.embedding(x, weight)


def gelu(x, approximate=False):
    """``approximate=True`` is the tanh form, as ``jax.nn.gelu``'s default."""
    return _tF.gelu(x, approximate="tanh" if approximate else "none")


def dropout(x, p=0.5, training=True, generator=None):
    """Upscale-in-train dropout: kept values are divided by 1 - p."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


def layer_norm(x, normalized_shape, weight, bias, epsilon=1e-5):
    """Layer norm over the last dim with an affine ``weight`` and ``bias``
    (the form every layer of the slice uses), by the layer-norm kernel."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    if list(normalized_shape) != [x.shape[-1]]:
        raise NotImplementedError(
            f"layer_norm over {list(normalized_shape)}: only the last dim "
            f"({x.shape[-1]}) is ported")
    return _ln.fused_layer_norm(x, weight, bias, epsilon)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """Batched attention in paddle's [B, L, H, D] layout. ``dropout_p``
    drops attention weights in training mode only."""
    p_eff = dropout_p if training else 0.0
    return _fa.flash_attention(query, key, value, mask=attn_mask,
                               causal=is_causal, dropout_p=p_eff,
                               generator=generator)
