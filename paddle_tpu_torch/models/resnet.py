"""ResNet family (counterpart of ``paddle_tpu/models/resnet.py``; the
reference's own source is ``python/paddle/vision/models/resnet.py``).

With the defaults (``fused_bn=True``, ``fused_conv_bn=True``) every block
BN runs as the fused BN(+add)+ReLU, and each block's stride-1 1x1 convs in
channels-last layout (``data_format="NHWC"``) take the fused 1x1 conv + BN
statistics chain through ``F.conv2d_bn``; the 3x3/7x7 and strided convs
stay ``F.conv2d``. The downsample branch keeps a plain BatchNorm2D without
an activation, as in the reference. Parameter and buffer names are the
reference's (``layer1.0.bn1._mean``), so weights cross by name.
"""
from __future__ import annotations

from .. import nn
from ..distributed.fleet import utils as fleet_utils
from ..nn import functional as F
from ..ops.kernels import fused_conv_bn as _fcb


def _conv_bn(conv, bn, x, residual=None):
    """The block tail bn(conv(x), residual), through ``F.conv2d_bn``'s
    fused chain where the conv and mode allow it (reference l.7-33)."""
    ugs = bn._use_global_stats
    if ugs is None:
        ugs = not bn.training
    if (not ugs) and _fcb.eligible(tuple(x.shape), tuple(conv.weight.shape),
                                   conv._stride, conv._padding,
                                   conv._dilation, conv._groups,
                                   conv._data_format, x.dtype):
        return F.conv2d_bn(
            x, conv.weight, bn._mean, bn._variance, bn.weight, bn.bias,
            training=bn.training, momentum=bn._momentum,
            epsilon=bn._epsilon, stride=conv._stride,
            padding=conv._padding, dilation=conv._dilation,
            groups=conv._groups, data_format=conv._data_format,
            use_global_stats=bn._use_global_stats, act=bn._act,
            residual=residual)
    return bn(conv(x), residual)


def _kw(device, dtype, generator=None):
    kw = dict(device=device, dtype=dtype)
    if generator is not None:
        kw["generator"] = generator
    return kw


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", fused_conv_bn=True, *, device=None,
                 dtype=None, generator=None):
        super().__init__(device, dtype)
        self._fused = norm_layer is None
        self._fused_conv = fused_conv_bn and self._fused
        norm_layer = norm_layer or nn.BatchNorm2D
        df = dict(data_format=data_format)
        act = dict(act="relu") if self._fused else {}
        kw, bkw = _kw(device, dtype, generator), _kw(device, dtype)
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, **df, **kw)
        self.bn1 = norm_layer(planes, **df, **act, **bkw)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                               **df, **kw)
        self.bn2 = norm_layer(planes, **df, **act, **bkw)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        if self.downsample is not None:
            identity = self.downsample(x)
        if self._fused_conv:
            out = _conv_bn(self.conv1, self.bn1, x)
            return _conv_bn(self.conv2, self.bn2, out, identity)
        if self._fused:
            out = self.bn1(self.conv1(x))
            return self.bn2(self.conv2(out), identity)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", fused_conv_bn=True, *, device=None,
                 dtype=None, generator=None):
        super().__init__(device, dtype)
        self._fused = norm_layer is None
        self._fused_conv = fused_conv_bn and self._fused
        norm_layer = norm_layer or nn.BatchNorm2D
        df = dict(data_format=data_format)
        act = dict(act="relu") if self._fused else {}
        kw, bkw = _kw(device, dtype, generator), _kw(device, dtype)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False, **df,
                               **kw)
        self.bn1 = norm_layer(width, **df, **act, **bkw)
        self.conv2 = nn.Conv2D(width, width, 3, padding=1, stride=stride,
                               groups=groups, dilation=dilation,
                               bias_attr=False, **df, **kw)
        self.bn2 = norm_layer(width, **df, **act, **bkw)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False, **df, **kw)
        self.bn3 = norm_layer(planes * self.expansion, **df, **act, **bkw)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        if self.downsample is not None:
            identity = self.downsample(x)
        if self._fused_conv:
            # conv1/conv3 are the 1x1s of the fused chain; conv2 (3x3)
            # falls back inside conv2d_bn to conv -> fused BN
            out = _conv_bn(self.conv1, self.bn1, x)
            out = _conv_bn(self.conv2, self.bn2, out)
            return _conv_bn(self.conv3, self.bn3, out, identity)
        if self._fused:
            out = self.bn1(self.conv1(x))
            out = self.bn2(self.conv2(out))
            return self.bn3(self.conv3(out), identity)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


class ResNet(nn.Layer):
    """ResNet over ``block`` (BasicBlock or BottleneckBlock) at ``depth``.

    ``data_format="NHWC"`` runs channels-last throughout, the layout of the
    fused 1x1 chain. ``fused_bn=False`` keeps every BN+ReLU(+add)
    unfused; ``fused_conv_bn=False`` keeps conv then fused BN.
    ``recompute=True`` rematerialises each residual stage in training
    (``distributed.fleet.utils.recompute``; the running statistics still
    move once a step). The model is built on ``device`` (``cuda`` unless
    the caller says otherwise), its weights drawn from ``generator``."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, recompute=False,
                 data_format="NCHW", fused_bn=True, fused_conv_bn=True, *,
                 device=None, dtype=None, generator=None):
        super().__init__(device, dtype)
        self._recompute = recompute
        self._data_format = data_format
        self._fused_bn = fused_bn
        self._fused_conv_bn = fused_conv_bn and fused_bn
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self._kw = _kw(device, dtype, generator)
        self._bkw = _kw(device, dtype)
        df = dict(data_format=data_format)
        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                               bias_attr=False, **df, **self._kw)
        self.bn1 = nn.BatchNorm2D(self.inplanes, **df,
                                  act="relu" if fused_bn else None,
                                  **self._bkw)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1, **df)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1), **df)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes,
                                **self._kw)
        self.name_parameters()

    def _make_layer(self, block, planes, blocks, stride=1):
        # blocks see norm_layer=None when fusion is on: the block then picks
        # the fused BN(+add)+ReLU tails
        block_norm = None if self._fused_bn else nn.BatchNorm2D
        df = dict(data_format=self._data_format)
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False, **df, **self._kw),
                nn.BatchNorm2D(planes * block.expansion, **df, **self._bkw))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, 1, block_norm,
                        data_format=self._data_format,
                        fused_conv_bn=self._fused_conv_bn, **self._kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=block_norm,
                                data_format=self._data_format,
                                fused_conv_bn=self._fused_conv_bn,
                                **self._kw))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.bn1(self.conv1(x))
        if not self._fused_bn:  # the fused stem BN applied the ReLU
            x = self.relu(x)
        x = self.maxpool(x)
        stages = (self.layer1, self.layer2, self.layer3, self.layer4)
        if self._recompute and self.training:
            for stage in stages:
                x = fleet_utils.recompute(stage, x)
        else:
            for stage in stages:
                x = stage(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = F.flatten(x, 1)
            x = self.fc(x)
        return x


def _resnet(block, depth, pretrained, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights are not available (no "
                         "downloads); load a state dict instead")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)
