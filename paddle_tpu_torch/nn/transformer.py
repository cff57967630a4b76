"""Transformer layers (counterpart of ``paddle_tpu/nn/transformer.py``):
``MultiHeadAttention`` with its ``Cache``/``StaticCache``, the encoder and
decoder layers and stacks, and ``Transformer``.

Attention goes through ``F.scaled_dot_product_attention`` in paddle's
[batch, seq, heads, head_dim] layout: unmasked attention and a 4-D bool
mask whose dims are each 1 or full (a key-padding or causal-and-padding
mask, True = attend) take the flash kernels (their plain versions on the
CPU), any other mask the torch composition, as in the reference.
Parameter names are the reference's
(``layers.0.self_attn.q_proj.weight``, ``linear1``, ``norm1``, ...), so its
weights load one to one. Every layer takes ``device=``, ``dtype=`` and
``generator=`` as the port's models do.
"""
from __future__ import annotations

import collections
import copy

import torch

from . import functional as F
from .layer import Layer
from .layers_common import Dropout, LayerList, LayerNorm, Linear


def _kw(device, dtype, generator):
    return dict(device=device, dtype=dtype, generator=generator)


class MultiHeadAttention(Layer):
    """Attention over ``num_heads`` heads with separate q, k, v and output
    projections. ``forward`` returns the output, then ``None`` for the
    weights when ``need_weights`` (the reference computes none), then the
    updated ``Cache`` when one was passed."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=None, generator=None):
        super().__init__(device, dtype)
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        attrs = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                     **_kw(device, dtype, generator))
        self.q_proj = Linear(embed_dim, embed_dim, **attrs)
        self.k_proj = Linear(self.kdim, embed_dim, **attrs)
        self.v_proj = Linear(self.vdim, embed_dim, **attrs)
        self.out_proj = Linear(embed_dim, embed_dim, **attrs)

    def _shape(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        """A ``StaticCache`` of the projected key and value (cross
        attention), or an empty incremental ``Cache`` [B, 0, H, D]."""
        if type == MultiHeadAttention.StaticCache:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        empty = torch.zeros(key.shape[0], 0, self.num_heads, self.head_dim,
                            device=key.device)  # float32, as the reference's
        return self.Cache(empty, empty)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._shape(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        outs = [out]
        if self.need_weights:
            outs.append(None)
        if cache is not None and not isinstance(cache, self.StaticCache):
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)


class TransformerEncoderLayer(Layer):
    """Self-attention and a feed-forward block, each with a residual and a
    layer norm, after (post-LN) or before (``normalize_before``) it."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, dtype=None, generator=None):
        super().__init__(device, dtype)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = _kw(device, dtype, generator)
        attrs = dict(weight_attr=weight_attr, bias_attr=bias_attr, **kw)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **attrs)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **attrs)
        self.norm1 = LayerNorm(d_model, device=device, dtype=dtype)
        self.norm2 = LayerNorm(d_model, device=device, dtype=dtype)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


def _clones(layer, n):
    """``layer`` and n - 1 deep copies of it (the reference's stacks start
    every layer from the same weights)."""
    return LayerList([layer] + [copy.deepcopy(layer) for _ in range(n - 1)])


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__(encoder_layer._device, encoder_layer._dtype)
        self.layers = _clones(encoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    """Self-attention, cross-attention over ``memory`` and a feed-forward
    block, each with a residual and a layer norm."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 *, device=None, dtype=None, generator=None):
        super().__init__(device, dtype)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = _kw(device, dtype, generator)
        attrs = dict(weight_attr=weight_attr, bias_attr=bias_attr, **kw)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, **kw)
        self.cross_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **attrs)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **attrs)
        self.norm1 = LayerNorm(d_model, device=device, dtype=dtype)
        self.norm2 = LayerNorm(d_model, device=device, dtype=dtype)
        self.norm3 = LayerNorm(d_model, device=device, dtype=dtype)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incr_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                             cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask,
                                  cache[1])
            if isinstance(tgt, tuple):
                tgt = tgt[0]
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr_cache, cache[1]))

    def gen_cache(self, memory):
        incr = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incr, static


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__(decoder_layer._device, decoder_layer._dtype)
        self.layers = _clones(decoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask,
                                        memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(Layer):
    """Encoder-decoder transformer; ``custom_encoder``/``custom_decoder``
    replace the built stacks."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(device, dtype)
        kw = _kw(device, dtype, generator)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            norm = (LayerNorm(d_model, device=device, dtype=dtype)
                    if normalize_before else None)
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **kw), num_encoder_layers,
                norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            norm = (LayerNorm(d_model, device=device, dtype=dtype)
                    if normalize_before else None)
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **kw), num_decoder_layers,
                norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length):
        """[length, length] float32 mask: 0 on and below the diagonal,
        -inf above it (an additive mask, which attention composes)."""
        full = torch.full((length, length), float("-inf"),
                          device=self._device)
        return torch.triu(full, diagonal=1)


__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]
