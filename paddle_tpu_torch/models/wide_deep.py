"""Wide&Deep CTR model over PS-resident sparse embeddings (counterpart of
``paddle_tpu/models/wide_deep.py``).

The PS path's flagship model family (Wide&Deep / DeepFM, paddle's
``test_dist_fleet_ctr.py``): the sparse slots hit `SparseEmbedding` (host
PS pull/push), the dense tower is ordinary torch on the layer's device.
Parameter names are the reference's (``deep.0.weight`` ...), so
:func:`load_dense_params` carries its dense weights across; the sparse
rows need no transfer (both packages' servers draw a row from its key and
the table's seed).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .. import nn
from ..distributed.ps import SparseEmbedding
from ..utils.convert import load_numpy_params


class WideDeep(nn.Layer):
    """`num_slots` categorical slots + `dense_dim` dense features -> CTR
    logit. ``device`` (``cuda`` unless the caller passes another) holds the
    dense tower and receives the looked-up rows; ``generator`` draws the
    dense tower's initial weights."""

    def __init__(self, num_slots: int = 4, embedding_dim: int = 8,
                 dense_dim: int = 4, hidden: int = 32,
                 sparse_lr: float = 0.05, table_base: int = 0,
                 client=None, *, device=None, generator=None):
        super().__init__(device)
        self.num_slots = num_slots
        self.embedding_dim = embedding_dim
        self.embeddings = nn.LayerList([
            SparseEmbedding(table_id=table_base + i,
                            embedding_dim=embedding_dim,
                            optimizer="sgd", learning_rate=sparse_lr,
                            client=client, device=device)
            for i in range(num_slots)
        ])
        # "wide" half: one scalar weight per slot via a dim-1 PS table
        self.wide = SparseEmbedding(table_id=table_base + num_slots,
                                    embedding_dim=1, optimizer="sgd",
                                    learning_rate=sparse_lr, client=client,
                                    device=device)
        kw = dict(device=device, generator=generator)
        self.deep = nn.Sequential(
            nn.Linear(num_slots * embedding_dim + dense_dim, hidden, **kw),
            nn.ReLU(),
            nn.Linear(hidden, hidden, **kw),
            nn.ReLU(),
            nn.Linear(hidden, 1, **kw),
        )
        self.name_parameters()

    def forward(self, slot_ids, dense_x):
        """slot_ids: int [batch, num_slots]; dense_x: float [batch,
        dense_dim]."""
        embs = [emb(slot_ids[:, i]) for i, emb in enumerate(self.embeddings)]
        deep_in = torch.cat(embs + [dense_x], dim=-1)
        deep_out = self.deep(deep_in)                  # [batch, 1]
        wide_out = self.wide(slot_ids).sum(dim=1)      # [batch, 1]
        return deep_out + wide_out


def load_dense_params(model: torch.nn.Module,
                      params: Mapping[str, np.ndarray]) -> None:
    """Copy the reference model's dense parameters ({name: array} by the
    reference's names, e.g. ``{k: np.asarray(p.data) for k, p in
    ref.named_parameters()}``) into the port's `WideDeep` or `DeepFM`, in
    place; a missing, extra or misshapen name raises."""
    load_numpy_params(model, params, strict=True)
