"""BERT/ERNIE-style bidirectional encoder (counterpart of
``paddle_tpu/models/bert.py``): word, position and token-type embeddings
with a layer norm (eps 1e-12), a post-LN ``nn.TransformerEncoder`` with
GELU, and a tanh pooler over the first token.

Unmasked attention takes the flash kernels (non-causal); an
``attention_mask`` becomes the reference's additive [B, 1, 1, L] float
mask, (1 - mask) * -1e4, which attention composes on a card as the
reference composes float masks (counted in ``ops.kernels.composed_stats``).
"""
from __future__ import annotations

import dataclasses

import torch

from .. import nn
from .._platform import resolve_device
from ..nn import functional as F


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def large():
        return BertConfig(hidden_size=1024, num_layers=24, num_heads=16,
                          intermediate_size=4096)

    @staticmethod
    def tiny():
        return BertConfig(vocab_size=1000, hidden_size=64, num_layers=2,
                          num_heads=4, intermediate_size=128, dropout=0.0)


def _kw(device, dtype, generator):
    return dict(device=device, dtype=dtype, generator=generator)


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg: BertConfig, device=None, dtype=None,
                 generator=None):
        super().__init__(device, dtype)
        kw = _kw(device, dtype, generator)
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            **kw)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, **kw)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size, **kw)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, epsilon=1e-12,
                                       device=device, dtype=dtype)
        self.dropout = nn.Dropout(cfg.dropout)

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertPooler(nn.Layer):
    def __init__(self, cfg: BertConfig, device=None, dtype=None,
                 generator=None):
        super().__init__(device, dtype)
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size,
                               **_kw(device, dtype, generator))

    def forward(self, hidden):
        return F.tanh(self.dense(hidden[:, 0]))


class Bert(nn.Layer):
    """BERT on ``device`` (``cuda`` unless the caller passes ``"cpu"``),
    weights drawn from ``generator`` (PyTorch's default CPU generator when
    None). ``forward`` returns (sequence output, pooled output)."""

    def __init__(self, cfg: BertConfig, device=None, dtype=None,
                 generator=None):
        device = resolve_device(device)
        super().__init__(device, dtype)
        kw = _kw(device, dtype, generator)
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, **kw)
        enc_layer = nn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            dropout=cfg.dropout, activation="gelu", **kw)
        self.encoder = nn.TransformerEncoder(enc_layer, cfg.num_layers)
        self.pooler = BertPooler(cfg, **kw)
        self.name_parameters()

    @property
    def device(self) -> torch.device:
        return self.embeddings.word_embeddings.weight.device

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        if attention_mask is not None:
            # [B, L] 1/0 -> additive [B, 1, 1, L]
            m = (1.0 - attention_mask.float()) * -1e4
            attention_mask = m.reshape(m.shape[0], 1, 1, m.shape[1])
        seq = self.encoder(x, attention_mask)
        return seq, self.pooler(seq)


class BertForPretraining(nn.Layer):
    """BERT with the masked-LM head over every token and the
    next-sentence head over the pooled output."""

    def __init__(self, cfg: BertConfig, device=None, dtype=None,
                 generator=None):
        device = resolve_device(device)
        super().__init__(device, dtype)
        kw = _kw(device, dtype, generator)
        self.bert = Bert(cfg, **kw)
        self.mlm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, **kw)
        self.nsp_head = nn.Linear(cfg.hidden_size, 2, **kw)
        self.name_parameters()

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.mlm_head(seq), self.nsp_head(pooled)


__all__ = ["BertConfig", "BertEmbeddings", "BertPooler", "Bert",
           "BertForPretraining"]
