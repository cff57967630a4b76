"""Fused transformer building blocks (counterpart of
``paddle_tpu/incubate/nn/__init__.py``): ``FusedMultiHeadAttention``,
``FusedFeedForward`` and ``FusedTransformerEncoderLayer``.

As in the reference, the fusion is (a) one packed QKV projection feeding
the flash-attention kernels (``ops/kernels/flash_attention.py``) and (b)
the residual + dropout + layer-norm epilogue composed around the
layer-norm kernel's Function (``ops/kernels/layer_norm.py:
fused_residual_dropout_ln``). ``pre_layer_norm`` (``normalize_before``)
normalises the input instead and ends with the residual add. The
products and adds run in the inputs' type: the reference's fused ops are
on neither AMP list, so autocast leaves them alone.
"""
from __future__ import annotations

import torch

from ...nn import functional as F
from ...nn.layer import Layer, xavier_uniform
from ...ops.kernels.flash_attention import flash_attention
from ...ops.kernels.layer_norm import (fused_layer_norm,
                                       fused_residual_dropout_ln)


class FusedMultiHeadAttention(Layer):
    """Packed QKV projection, attention, output projection and the
    residual/dropout/LN epilogue. ``attn_mask="causal"`` selects causal
    attention; a tensor is an additive or boolean mask, which composes."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, normalize_before=False,
                 need_weights=False, weight_attr=None, bias_attr=None,
                 epsilon=1e-5, *, device=None, dtype=None, generator=None):
        super().__init__(device, dtype)
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.normalize_before = normalize_before
        self.epsilon = epsilon
        E = embed_dim
        self.qkv_weight = self.create_parameter(
            xavier_uniform((E, 3 * E), generator))
        self.qkv_bias = self.create_parameter(torch.zeros(3 * E))
        self.linear_weight = self.create_parameter(
            xavier_uniform((E, E), generator))
        self.linear_bias = self.create_parameter(torch.zeros(E))
        self.ln_scale = self.create_parameter(torch.ones(E))
        self.ln_bias = self.create_parameter(torch.zeros(E))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        causal = isinstance(attn_mask, str) and attn_mask == "causal"
        mask = None if causal else attn_mask
        x = query
        B, L, E = x.shape
        H = self.num_heads
        h = (fused_layer_norm(x, self.ln_scale, self.ln_bias, self.epsilon)
             if self.normalize_before else x)
        qkv = torch.matmul(h, self.qkv_weight) + self.qkv_bias
        q, k, v = qkv.reshape(B, L, 3, H, E // H).unbind(2)
        p_attn = self.attn_dropout_rate if self.training else 0.0
        ctx = flash_attention(q, k, v, mask=mask, causal=causal,
                              dropout_p=p_attn)
        out = torch.matmul(ctx.reshape(B, L, E),
                           self.linear_weight) + self.linear_bias
        if self.normalize_before:
            out = F.dropout(out, self.dropout_rate, training=self.training)
            return (x + out).to(x.dtype)
        return fused_residual_dropout_ln(
            out, x, self.ln_scale, self.ln_bias, p=self.dropout_rate,
            eps=self.epsilon, training=self.training).to(x.dtype)


class FusedFeedForward(Layer):
    """linear1, activation (exact GELU or ReLU) with its dropout, linear2,
    and the residual/dropout/LN epilogue."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, dtype=None, generator=None):
        super().__init__(device, dtype)
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = (act_dropout_rate if act_dropout_rate
                                 is not None else dropout_rate)
        self.activation = activation
        self.epsilon = epsilon
        self.linear1_weight = self.create_parameter(
            xavier_uniform((d_model, dim_feedforward), generator))
        self.linear1_bias = self.create_parameter(
            torch.zeros(dim_feedforward))
        self.linear2_weight = self.create_parameter(
            xavier_uniform((dim_feedforward, d_model), generator))
        self.linear2_bias = self.create_parameter(torch.zeros(d_model))
        self.ln_scale = self.create_parameter(torch.ones(d_model))
        self.ln_bias = self.create_parameter(torch.zeros(d_model))

    def forward(self, src):
        h = (fused_layer_norm(src, self.ln_scale, self.ln_bias, self.epsilon)
             if self.normalize_before else src)
        h = torch.matmul(h, self.linear1_weight) + self.linear1_bias
        h = F.gelu(h) if self.activation == "gelu" else F.relu(h)
        h = F.dropout(h, self.act_dropout_rate, training=self.training)
        h = torch.matmul(h, self.linear2_weight) + self.linear2_bias
        if self.normalize_before:
            h = F.dropout(h, self.dropout_rate, training=self.training)
            return (src + h).to(src.dtype)
        return fused_residual_dropout_ln(
            h, src, self.ln_scale, self.ln_bias, p=self.dropout_rate,
            eps=self.epsilon, training=self.training).to(src.dtype)


class FusedTransformerEncoderLayer(Layer):
    """``FusedMultiHeadAttention`` then ``FusedFeedForward``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False, *,
                 device=None, dtype=None, generator=None):
        super().__init__(device, dtype)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=(attn_dropout_rate if attn_dropout_rate
                               is not None else dropout_rate),
            normalize_before=normalize_before, **kw)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, **kw)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer"]
