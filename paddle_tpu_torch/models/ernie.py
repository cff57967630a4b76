"""ERNIE (counterpart of ``paddle_tpu/models/ernie.py``): BERT's encoder
with ERNIE's configurations and the knowledge-masked MLM head.

Knowledge masking (whole spans: words, entities, phrases) is a change of
the data, ``ernie_mask_tokens``, not of the architecture. The MLM loss is
the fused softmax cross-entropy over the vocabulary (V 40,000 for
``ErnieConfig.base()``) with ``ignore_index`` outside the spans.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import nn
from .._platform import resolve_device
from ..nn import functional as F
from .bert import Bert, BertConfig


@dataclass
class ErnieConfig(BertConfig):
    @staticmethod
    def base():
        # ERNIE-3.0-Base: 12 layers, hidden 768, 12 heads, vocab 40,000
        return ErnieConfig(vocab_size=40000, hidden_size=768, num_layers=12,
                           num_heads=12, intermediate_size=3072)

    @staticmethod
    def tiny():
        return ErnieConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                           num_heads=2, intermediate_size=128,
                           max_position_embeddings=128, dropout=0.0)


class Ernie(Bert):
    """The encoder is BERT's; the class is kept for the name
    (``ErnieModel``)."""


class ErnieForPretraining(nn.Layer):
    """MLM head over the ERNIE encoder: dense, GELU, layer norm, then the
    vocabulary projection."""

    def __init__(self, cfg: ErnieConfig, device=None, dtype=None,
                 generator=None):
        device = resolve_device(device)
        super().__init__(device, dtype)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.ernie = Ernie(cfg, **kw)
        self.mlm_transform = nn.Linear(cfg.hidden_size, cfg.hidden_size,
                                       **kw)
        self.mlm_norm = nn.LayerNorm(cfg.hidden_size, device=device,
                                     dtype=dtype)
        self.mlm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, **kw)
        self.name_parameters()

    def forward(self, input_ids, token_type_ids=None):
        seq_out, _pooled = self.ernie(input_ids,
                                      token_type_ids=token_type_ids)
        h = F.gelu(self.mlm_transform(seq_out))
        return self.mlm_head(self.mlm_norm(h))

    def loss(self, input_ids, labels, token_type_ids=None,
             ignore_index: int = -100):
        logits = self(input_ids, token_type_ids=token_type_ids)
        return F.cross_entropy(logits, labels, ignore_index=ignore_index)


def ernie_mask_tokens(input_ids: np.ndarray, spans, mask_token_id: int,
                      ignore_index: int = -100):
    """Knowledge masking: replace whole spans by ``mask_token_id``.

    spans: for each batch row, a list of (start, end) half-open intervals.
    Returns (masked_ids, labels): labels hold the original ids inside the
    spans and ``ignore_index`` elsewhere."""
    ids = np.array(input_ids, copy=True)
    labels = np.full_like(ids, ignore_index)
    for b, row_spans in enumerate(spans):
        for s, e in row_spans:
            labels[b, s:e] = ids[b, s:e]
            ids[b, s:e] = mask_token_id
    return ids, labels


__all__ = ["ErnieConfig", "Ernie", "ErnieForPretraining",
           "ernie_mask_tokens"]
