"""The layers of the serving slice (counterpart of
``paddle_tpu/nn/layers_common.py``): ``Linear``, ``Embedding``,
``LayerNorm``, ``Dropout`` and ``LayerList``.

Layouts stay paddle's so weights map one to one: ``Linear.weight`` is
[in, out] and the layer computes ``x @ W + b``.
"""
from __future__ import annotations

import torch

from . import functional as F
from .layer import Layer, xavier_uniform


class Linear(Layer):
    def __init__(self, in_features, out_features, bias_attr=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__(device, dtype)
        self.weight = self.create_parameter(
            xavier_uniform((in_features, out_features), generator))
        self.bias = (None if bias_attr is False else
                     self.create_parameter(torch.zeros(out_features)))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in={self.weight.shape[0]}, out={self.weight.shape[1]}"


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, *, device=None,
                 dtype=None, generator=None):
        super().__init__(device, dtype)
        self.weight = self.create_parameter(
            xavier_uniform((num_embeddings, embedding_dim), generator))

    def forward(self, x):
        return F.embedding(x, self.weight)


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, *, device=None,
                 dtype=None):
        super().__init__(device, dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(torch.ones(normalized_shape))
        self.bias = self.create_parameter(torch.zeros(normalized_shape))

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class Dropout(torch.nn.Module):
    """Drops activations in training mode; the identity in ``eval()``."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.dropout(x, p=self.p, training=self.training)


class LayerList(torch.nn.ModuleList):
    """paddle's LayerList: sub-layers named "0", "1", ... in order."""
