"""DeepFM CTR model over PS-resident sparse embeddings (counterpart of
``paddle_tpu/models/deepfm.py``).

The second PS-path flagship next to Wide&Deep (paddle's
``test_dist_fleet_ctr.py`` family). FM half: first-order weights plus
pairwise second-order interactions by the sum-square/square-sum identity;
deep half: an MLP over the concatenated embeddings. Both halves share the
PS embedding tables. ``wide_deep.load_dense_params`` loads the reference's
dense weights.
"""
from __future__ import annotations

import torch

from .. import nn
from ..distributed.ps import SparseEmbedding


class DeepFM(nn.Layer):
    """``device`` (``cuda`` unless the caller passes another) holds the
    MLP and receives the looked-up rows; ``generator`` draws its initial
    weights."""

    def __init__(self, num_slots: int = 4, embedding_dim: int = 8,
                 hidden: int = 32, sparse_lr: float = 0.05,
                 table_base: int = 100, client=None, *, device=None,
                 generator=None):
        super().__init__(device)
        self.num_slots = num_slots
        self.embedding_dim = embedding_dim
        # second-order factors [slot ids -> dim-d vectors]
        self.fm_embeddings = nn.LayerList([
            SparseEmbedding(table_id=table_base + i,
                            embedding_dim=embedding_dim,
                            optimizer="sgd", learning_rate=sparse_lr,
                            client=client, device=device)
            for i in range(num_slots)
        ])
        # first-order weights [slot ids -> scalars]
        self.fm_first = SparseEmbedding(table_id=table_base + num_slots,
                                        embedding_dim=1, optimizer="sgd",
                                        learning_rate=sparse_lr,
                                        client=client, device=device)
        kw = dict(device=device, generator=generator)
        self.dnn = nn.Sequential(
            nn.Linear(num_slots * embedding_dim, hidden, **kw),
            nn.ReLU(),
            nn.Linear(hidden, hidden, **kw),
            nn.ReLU(),
            nn.Linear(hidden, 1, **kw),
        )
        self.name_parameters()

    def forward(self, slot_ids):
        """slot_ids: int [batch, num_slots] -> CTR logit [batch, 1]."""
        embs = [emb(slot_ids[:, i])
                for i, emb in enumerate(self.fm_embeddings)]
        stacked = torch.stack(embs, dim=1)            # [B, S, D]
        # FM second order: 0.5 * ((sum v)^2 - sum v^2) summed over D
        sum_v = stacked.sum(dim=1)                    # [B, D]
        sum_sq = (stacked * stacked).sum(dim=1)       # [B, D]
        second = 0.5 * (sum_v * sum_v - sum_sq).sum(dim=1, keepdim=True)
        first = self.fm_first(slot_ids).sum(dim=1)    # [B, 1]
        deep_in = torch.cat(embs, dim=-1)             # [B, S*D]
        deep = self.dnn(deep_in)
        return first + second + deep
