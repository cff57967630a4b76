"""Distributed (PS-resident) sparse embedding lookup with autograd
(counterpart of ``paddle_tpu/distributed/ps/embedding.py``).

Paddle's PS rewrite turns `embedding` lookups into
`distributed_lookup_table` / `distributed_push_sparse` ops
(``python/paddle/distributed/passes/ps_trainer_pass.py``,
``paddle/fluid/operators/pscore/distributed_lookup_table_op.cc``): the
forward pulls rows for the batch's feasigns from the PS, the backward
pushes per-row gradients; the optimizer update happens inside the server
table.

Here the pull happens on the host (numpy), and the gathered block goes to
the layer's device as an ordinary tensor, so everything downstream is
torch. The backward is an autograd Function that merges the gradients of
duplicate keys on the device (``index_add_``, what ``np.add.at`` does in
the reference), brings the merged block to the host and pushes it in one
``push_sparse``. Unique-ing keys before the pull both shrinks RPC traffic
and makes the push a correct duplicate-accumulating scatter.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as _tF

from ...nn.layer import Layer
from .client import TableConfig


class _PulledRows(torch.autograd.Function):
    """rows [u, dim] (pulled) gathered at ``inverse`` into [..., dim]; the
    backward merges the output's gradient per unique key and pushes it.
    ``rows`` is a leaf that asks for a gradient only so that the backward
    runs; it gets none."""

    @staticmethod
    def forward(ctx, rows, inverse, shape, push):
        ctx.save_for_backward(inverse)
        ctx.n_rows, ctx.push = rows.shape[0], push
        return rows.index_select(0, inverse).reshape(*shape, rows.shape[1])

    @staticmethod
    def backward(ctx, g):
        (inverse,) = ctx.saved_tensors
        g = g.reshape(-1, g.shape[-1]).float()
        merged = torch.zeros((ctx.n_rows, g.shape[1]), dtype=torch.float32,
                             device=g.device)
        merged.index_add_(0, inverse, g)
        ctx.push(merged.cpu().numpy())
        return None, None, None, None


class SparseEmbedding(Layer):
    """Embedding whose table lives on the parameter servers.

    Unlike `nn.Embedding` there is no local weight parameter;
    `parameters()` is empty and the optimizer never sees this layer —
    updates are applied server-side on `backward()` (paddle's server-side
    sgd rules, ``ps/table/sparse_sgd_rule.cc``). ``device``: where the
    looked-up rows go (``cuda`` unless the caller passes another).
    """

    def __init__(self, table_id: int, embedding_dim: int,
                 optimizer: str = "sgd", learning_rate: float = 0.01,
                 init_range: float = 0.05, seed: int = 0,
                 client=None, name: Optional[str] = None, *, device=None):
        super().__init__(device)
        self._table_cfg = TableConfig(
            table_id=table_id, kind="sparse", dim=embedding_dim,
            optimizer=optimizer, learning_rate=learning_rate,
            init_range=init_range, seed=seed)
        self._dim = embedding_dim
        self._client = client
        self._created = False

    @property
    def client(self):
        if self._client is None:
            from .runtime import get_client
            self._client = get_client()
        return self._client

    def _ensure_table(self):
        if not self._created:
            self.client.create_table(self._table_cfg)
            self._created = True

    def forward(self, ids) -> torch.Tensor:
        """ids: int tensor or array [...] -> embeddings [..., dim].

        Three modes: the eager host pull (default); and, under
        `HeterPSTrainStep` (heter.py), routing capture, which records the
        concrete ids and returns ``meta`` zeros, and the rows feed, where
        the lookup is ``rows[inverse]`` over the step's device tensors, so
        autograd's gradient with respect to ``rows`` is already merged per
        key."""
        from . import heter as _heter

        cap = _heter._capturing()
        if cap is not None:
            ids_t = torch.as_tensor(ids)
            cap.append(ids_t)
            _heter._ROUTE.plan.append((self, tuple(ids_t.shape)))
            return torch.zeros(tuple(ids_t.shape) + (self._dim,),
                               dtype=torch.float32, device="meta")
        feed = _heter._feeding()
        if feed is not None:
            item = feed.pop(0)
            out = _tF.embedding(item["inverse"], item["rows"])
            return out.reshape(tuple(ids.shape) + (self._dim,))

        self._ensure_table()
        client = self.client
        tid = self._table_cfg.table_id

        ids_np = (ids.detach().cpu().numpy() if isinstance(ids, torch.Tensor)
                  else np.asarray(ids))
        shape = ids_np.shape
        flat = ids_np.reshape(-1).astype(np.uint64)
        uniq, inverse = np.unique(flat, return_inverse=True)

        rows = client.pull_sparse(tid, uniq)               # [u, dim] host
        rows_t = torch.from_numpy(rows).to(self._device)
        inv_t = torch.from_numpy(inverse.reshape(-1).astype(np.int64)).to(
            self._device)
        if not torch.is_grad_enabled():
            return rows_t.index_select(0, inv_t).reshape(*shape, self._dim)

        def push(merged):
            client.push_sparse(tid, uniq, merged)

        return _PulledRows.apply(rows_t.requires_grad_(True), inv_t, shape,
                                 push)
