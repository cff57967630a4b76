"""The layers of the ported slices (counterpart of
``paddle_tpu/nn/layers_common.py``): ``Linear``, ``Embedding``,
``LayerNorm``, ``Dropout``, ``LayerList``, ``Sequential`` (l.25),
``Conv2D`` (l.277), ``BatchNorm2D`` (l.404), ``SyncBatchNorm`` (l.415),
``MaxPool2D`` (l.484), ``AdaptiveAvgPool2D`` (l.525), ``ReLU`` and
``BCEWithLogitsLoss`` (l.678).

Layouts and names stay paddle's so weights map one to one:
``Linear.weight`` is [in, out] and the layer computes ``x @ W + b``;
``Conv2D.weight`` is (O, I / groups, kh, kw) in both data formats; a
batch norm holds ``weight``, ``bias`` and the fp32 buffers ``_mean`` and
``_variance``.
"""
from __future__ import annotations

import math

import torch

from . import functional as F
from .layer import Layer, xavier_uniform


class Linear(Layer):
    """``x @ W + b`` with the reference's signature (l.136):
    ``bias_attr=False`` leaves out the bias; ``weight_attr=False`` keeps
    the default weight (and the bias), as in the reference; any other
    attribute than None or False raises (``_no_attr``)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(device, dtype)
        _no_attr(weight_attr, "Linear weight_attr")
        no_bias = _no_attr(bias_attr, "Linear bias_attr")
        self.weight = self.create_parameter(
            xavier_uniform((in_features, out_features), generator))
        self.bias = (None if no_bias else
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
    """``F.dropout`` in the layer's training mode, with the reference's
    signature (l.172): ``axis`` and ``mode`` as there."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


class LayerList(torch.nn.ModuleList):
    """paddle's LayerList: sub-layers named "0", "1", ... in order."""


class Sequential(torch.nn.Sequential):
    """paddle's Sequential: sub-layers named "0", "1", ... called in
    order."""


class ReLU(torch.nn.Module):
    def forward(self, x):
        return F.relu(x)


def _no_attr(attr, what):
    """``None`` (the default initialiser) or ``False`` (no parameter) are
    the attributes the port takes."""
    if attr not in (None, False):
        raise NotImplementedError(f"{what}: only None or False is ported")
    return attr is False


class Conv2D(Layer):
    """2-D convolution; the weight is (out, in / groups, kh, kw) in both
    data formats, drawn as paddle's KaimingUniform (U(-a, a),
    a = sqrt(6 / fan_in)), the bias (if any) as U(-1/sqrt(fan_in), ...)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None, generator=None):
        super().__init__(device, dtype)
        if padding_mode != "zeros":
            raise NotImplementedError("Conv2D: only zero padding is ported")
        _no_attr(weight_attr, "Conv2D weight_attr")
        ks = tuple(kernel_size) if isinstance(kernel_size, (list, tuple)) \
            else (kernel_size,) * 2
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        fan_in = (in_channels // groups) * ks[0] * ks[1]
        a = math.sqrt(6.0 / fan_in)
        self.weight = self.create_parameter(torch.empty(
            (out_channels, in_channels // groups) + ks).uniform_(
                -a, a, generator=generator))
        bound = 1 / math.sqrt(fan_in)
        self.bias = (None if _no_attr(bias_attr, "Conv2D bias_attr") else
                     self.create_parameter(torch.empty(out_channels).uniform_(
                         -bound, bound, generator=generator)))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class _BatchNormBase(Layer):
    """Batch norm over the channel axis, in the reference's slots (l.368;
    ``name`` is taken and not used). ``act="relu"`` fuses the
    activation, and ``forward(x, residual)`` a residual add before it, into
    the fused BN kernels in training mode (``F.batch_norm``). The running
    statistics are fp32 buffers whatever the layer's type, moved in place
    with paddle's momentum."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, act=None, *,
                 device=None, dtype=None):
        super().__init__(device, dtype)
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self._act = act
        self.weight = (None if _no_attr(weight_attr, "BatchNorm weight_attr")
                       else self.create_parameter(torch.ones(num_features)))
        self.bias = (None if _no_attr(bias_attr, "BatchNorm bias_attr")
                     else self.create_parameter(torch.zeros(num_features)))
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=torch.float32, device=self._device))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=torch.float32, device=self._device))

    def forward(self, x, residual=None):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats,
                            act=self._act, residual=residual)


class BatchNorm2D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm, in the reference's slots (l.415). Under a
    data-parallel group (a ``DataParallel``'s forward, a grouped
    ``TrainStep``) its training statistics are the group's, as every
    batch norm's of the port is (the reference's batch axis is global, so
    its plain batch norm is synchronized already); outside one it
    normalizes by the local batch, as the reference's eager use does.
    Its kernels are the port's own, not ``torch.nn.SyncBatchNorm``'s."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """The layer unchanged: its batch norms synchronize already."""
        return layer


class MaxPool2D(torch.nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW"):
        super().__init__()
        self._args = (kernel_size, stride, padding, ceil_mode, return_mask,
                      data_format)

    def forward(self, x):
        return F.max_pool2d(x, *self._args)


class AdaptiveAvgPool2D(torch.nn.Module):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self._output_size = output_size
        self._data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self._output_size, self._data_format)


class BCEWithLogitsLoss(torch.nn.Module):
    """``F.binary_cross_entropy_with_logits`` with the reference's slots
    (l.678; ``name`` is taken and not used)."""

    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self._kw = dict(weight=weight, reduction=reduction,
                        pos_weight=pos_weight)

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(logit, label, **self._kw)
