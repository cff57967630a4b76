"""Device-side hot-row embedding cache for heterogeneous-PS training
(counterpart of ``paddle_tpu/distributed/ps/cache.py``).

Paddle's heter-PS GPU row cache
(``paddle/fluid/framework/fleet/heter_ps/hashtable.h`` — hot feasigns live
in accelerator memory, the CPU PS is the backing store). Here the cache is
a fixed-capacity fp32 ``[capacity, dim]`` pair of CUDA tensors per table
(``values`` and ``gsum``) plus a host-side LRU index keyed by feasign:

* **hit** — the row is gathered ON THE CARD out of ``values``; no pull
  RPC, no host-to-device transfer for that row.
* **miss** — only the missing rows ride the pull RPC; a free (or
  LRU-evicted) slot is assigned and the row becomes device-resident.
* **gradients** — cached rows are updated on the card (``w -= lr * g``,
  the table's SGD rule) and the RAW gradient accumulates into ``gsum``.
  The PS sees the row again only on **eviction or flush**, when the
  accumulated gradient is pushed in one write-back RPC and the server
  applies ``w -= lr * sum(g)`` — what pushing every step gives, because SGD
  is linear in the gradient. So the cache REQUIRES ``optimizer="sgd"`` (or
  the additive ``"sum"``) tables; other tables are skipped with a warning.

Each buffer holds one spare row past ``capacity`` (the trash row): an
index that points at ``capacity`` (the padded tail of a bucket, a key
that found no slot) gathers that row, which reads 0, and scatters into it,
after which it is zeroed again. So padded and overflow positions never
touch a real slot (the reference drops them with ``mode="drop"`` and reads
0 with ``mode="fill"``). ``values`` and ``gsum`` are the ``[capacity,
dim]`` views of the buffers.

Concurrency contract (kept by ``HeterPSTrainStep``): ``plan()`` runs on
the prefetch thread but is PURE with respect to the index — it computes
the hit/miss split and slot assignments against the last committed state
and returns them in a `CachePlan`. The owning trainer calls
``commit(plan)`` on the main thread right before dispatching the step that
consumes the plan; an abandoned prefetch (mode flip, flush with a queued
bundle) is never committed, so the index cannot drift from the device
buffers. Every device write (``combine_batch`` / ``apply_batch`` /
write-back gathers) is issued on the main thread's stream, in order.

Cache events land in the metrics registry:
``embed_cache_events_total{event=hit|miss|eviction|writeback,table=}``.
"""
from __future__ import annotations

import warnings
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from ..._platform import resolve_device
from ...profiler import metrics as _metrics_mod

_REG = _metrics_mod.default_registry()
_M_EVENTS = _REG.counter(
    "embed_cache_events_total",
    "hot-row embedding cache events by event kind and table "
    "(hit/miss/eviction/writeback are per ROW, overflow counts rows that "
    "found no slot)")

# optimizers whose server-side update is linear in the pushed gradient, so
# deferring the push to eviction/flush is numerically equivalent. "sum"/
# "geo" tables (server OPT_SUM, ps.cc: w += g, lr ignored) are the lr = -1
# case of the SGD rule, wired up in build_caches.
CACHEABLE_OPTIMIZERS = ("sgd", "sum", "geo")


@dataclass
class CachePlan:
    """One batch's hit/miss decisions, computed against committed state.

    All index arrays are sized to the padded unique bucket ``U``; positions
    past ``n_unique``, and overflow positions that found no slot, carry the
    ``capacity`` sentinel (the trash row) in ``slot_idx``.
    """
    uniq: np.ndarray                 # [n] uint64 unique feasigns
    slot_idx: np.ndarray             # [U] int64, sentinel=capacity
    hit_mask: np.ndarray             # [U] bool
    miss_idx: np.ndarray             # [U] int64 into the miss-row bucket
    miss_keys: np.ndarray            # [m] uint64 keys to pull from the PS
    hits: List[int] = field(default_factory=list)        # keys to LRU-touch
    inserts: List[tuple] = field(default_factory=list)   # (key, slot)
    evicts: List[tuple] = field(default_factory=list)    # (key, slot)
    overflow: List[int] = field(default_factory=list)    # positions w/o slot

    @property
    def n_unique(self) -> int:
        return int(self.uniq.size)


def _combine_rows(vbuf, slot_idx, hit_mask, miss_rows, miss_idx):
    """Serve the padded unique bucket: cache rows for hits (a gather on the
    card), freshly pulled rows for misses. Padded-tail positions read rows
    that the inverse never addresses."""
    cached = vbuf.index_select(0, slot_idx)
    pulled = miss_rows.index_select(0, miss_idx)
    return torch.where(hit_mask[:, None], cached, pulled)


def _apply_step(vbuf, gbuf, slot_idx, hit_mask, rows, grows, lr):
    """Post-step cache update, in place: local SGD on the served rows and
    gradient accumulation. A miss slot's stale gsum (from the evicted
    previous tenant, already written back) is reset rather than inherited.
    Sentinel positions land in the trash row, which is zeroed after."""
    upd = rows - lr * grows
    prev = torch.where(hit_mask[:, None], gbuf.index_select(0, slot_idx),
                       0.0)
    vbuf.index_copy_(0, slot_idx, upd)
    gbuf.index_copy_(0, slot_idx, prev + grows)
    vbuf[-1].zero_()
    gbuf[-1].zero_()


def combine_batch(caches, plans_dev, miss_rows_t):
    """Serve every cached table's padded bucket. `plans_dev[i]` is
    (slot_idx, hit_mask, miss_idx) on the device."""
    return tuple(_combine_rows(c._vbuf, s, h, m, mi)
                 for c, (s, h, mi), m in zip(caches, plans_dev, miss_rows_t))


def apply_batch(caches, plans_dev, rows_t, grows_t):
    """Consume every cached table's row gradients, updating each cache's
    device buffers in place."""
    for c, (s, h, _), r, g in zip(caches, plans_dev, rows_t, grows_t):
        _apply_step(c._vbuf, c._gbuf, s, h, r, g, c.lr)


class HotRowCache:
    """Per-table device-resident LRU row cache (see the module docstring).
    ``device``: ``cuda`` unless the caller passes another."""

    def __init__(self, table_id: int, dim: int, capacity: int,
                 learning_rate: float, client, device=None):
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.table_id = int(table_id)
        self.dim = int(dim)
        self.capacity = int(capacity)
        self.lr = float(learning_rate)
        self.client = client
        self.device = resolve_device(device)
        # one spare (trash) row past capacity, kept at 0
        self._vbuf = torch.zeros((self.capacity + 1, self.dim),
                                 dtype=torch.float32, device=self.device)
        self._gbuf = torch.zeros_like(self._vbuf)
        # feasign -> slot, in LRU order (front = coldest)
        self._slots: "OrderedDict[int, int]" = OrderedDict()
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        # device_gather: rows served by the gather on the card (the hits of
        # the batches dispatched)
        self.stats = {"hit": 0, "miss": 0, "eviction": 0, "writeback": 0,
                      "overflow": 0, "invalidation": 0, "device_gather": 0}
        # server-side lifecycle hook: PSClient.shrink() must flush +
        # invalidate this cache or evicted rows would be served stale
        reg = getattr(client, "register_row_cache", None)
        if callable(reg):
            reg(self)

    @property
    def values(self) -> torch.Tensor:
        return self._vbuf[:self.capacity]

    @property
    def gsum(self) -> torch.Tensor:
        return self._gbuf[:self.capacity]

    # ------------------------------ planning -------------------------------
    def plan(self, uniq: np.ndarray, bucket: int) -> CachePlan:
        """Pure hit/miss split + slot assignment for one batch's unique keys
        (no index mutation — see the concurrency contract above)."""
        slot_idx = np.full(bucket, self.capacity, np.int64)
        hit_mask = np.zeros(bucket, bool)
        miss_idx = np.zeros(bucket, np.int64)
        plan = CachePlan(uniq=uniq, slot_idx=slot_idx, hit_mask=hit_mask,
                         miss_idx=miss_idx, miss_keys=uniq[:0])
        keys = uniq.tolist()  # Python ints, read once
        get = self._slots.get
        hit_pos, hit_slot, miss_pos, ins_pos, ins_slot = [], [], [], [], []
        free_cursor = len(self._free)
        # LRU victims are walked lazily, skipping rows this batch itself
        # uses and rows already claimed by an earlier miss in this same
        # plan; made on the first eviction, so an all-hit batch never scans
        # the index
        victims = None
        for i, k in enumerate(keys):
            slot = get(k)
            if slot is not None:
                hit_pos.append(i)
                hit_slot.append(slot)
                plan.hits.append(k)
                continue
            miss_pos.append(i)
            if free_cursor > 0:
                free_cursor -= 1
                slot = self._free[free_cursor]
            else:
                if victims is None:
                    batch_keys = set(keys)
                    victims = ((vk, vs) for vk, vs in self._slots.items()
                               if vk not in batch_keys)
                nxt = next(victims, None)
                if nxt is None:
                    plan.overflow.append(i)
                    continue
                vk, slot = nxt
                plan.evicts.append((vk, slot))
            ins_pos.append(i)
            ins_slot.append(slot)
            plan.inserts.append((k, slot))
        hit_mask[hit_pos] = True
        slot_idx[hit_pos] = hit_slot
        slot_idx[ins_pos] = ins_slot
        miss_idx[miss_pos] = np.arange(len(miss_pos))
        plan.miss_keys = uniq[miss_pos]
        return plan

    def commit(self, plan: CachePlan):
        """Apply a plan's index mutations (main thread, at dispatch time)."""
        for k in plan.hits:
            self._slots.move_to_end(k)
        for vk, _slot in plan.evicts:
            del self._slots[vk]
        n_ins = len(plan.inserts)
        if n_ins:
            del self._free[len(self._free) - (n_ins - len(plan.evicts)):]
        for k, slot in plan.inserts:
            self._slots[k] = slot
        self.stats["hit"] += len(plan.hits)
        self.stats["miss"] += len(plan.inserts) + len(plan.overflow)
        self.stats["eviction"] += len(plan.evicts)
        self.stats["overflow"] += len(plan.overflow)
        if _metrics_mod.enabled():
            t = str(self.table_id)
            if plan.hits:
                _M_EVENTS.inc(len(plan.hits), event="hit", table=t)
            misses = len(plan.inserts) + len(plan.overflow)
            if misses:
                _M_EVENTS.inc(misses, event="miss", table=t)
            if plan.evicts:
                _M_EVENTS.inc(len(plan.evicts), event="eviction", table=t)
            if plan.overflow:
                _M_EVENTS.inc(len(plan.overflow), event="overflow", table=t)

    # --------------------------- device ops --------------------------------
    def combine(self, plan_dev, miss_rows):
        """Gather serving the padded bucket (main thread)."""
        slot_idx, hit_mask, miss_idx = plan_dev
        return _combine_rows(self._vbuf, slot_idx, hit_mask, miss_rows,
                             miss_idx)

    def apply(self, plan_dev, rows, grows):
        """Consume the step's row gradients into the cache buffers."""
        slot_idx, hit_mask, _ = plan_dev
        _apply_step(self._vbuf, self._gbuf, slot_idx, hit_mask, rows, grows,
                    self.lr)

    def writeback_rows(self, slots_dev):
        """Gather pending gradients for evicted slots. MUST be issued
        before this step's `apply` so it reads the pre-overwrite gsum."""
        return self._gbuf.index_select(0, slots_dev)

    # ------------------------------ flush ----------------------------------
    def _pending(self):
        keys = np.fromiter(self._slots.keys(), np.uint64, len(self._slots))
        slots = np.fromiter(self._slots.values(), np.int64, len(self._slots))
        return keys, torch.from_numpy(slots).to(self.device)

    def _written_back(self, n: int):
        self._gbuf.zero_()
        self.stats["writeback"] += n
        if _metrics_mod.enabled():
            _M_EVENTS.inc(n, event="writeback", table=str(self.table_id))

    def flush(self, push_fn=None) -> int:
        """Push every slot's accumulated gradient to the PS and zero the
        accumulator; cached VALUES stay resident (the server now agrees
        with them). Returns rows written back."""
        if not self._slots:
            return 0
        keys, slots = self._pending()
        g = self._gbuf.index_select(0, slots).cpu().numpy()
        nz = np.any(g != 0.0, axis=1)
        n = int(nz.sum())
        if n:
            push = push_fn or (lambda k, v: self.client.push_sparse(
                self.table_id, k, v))
            push(keys[nz], g[nz])
            self._written_back(n)
        return n

    def invalidate(self) -> int:
        """Drop EVERY cached row (index + gradient accumulators), after a
        server-side shrink changed or removed rows under the cache: the
        next batch misses and pulls fresh. Call `flush()` FIRST when
        gradients may be pending (PSClient.shrink does): the accumulators
        are zeroed here. Returns the number of rows invalidated."""
        n = len(self._slots)
        self._slots.clear()
        self._free = list(range(self.capacity - 1, -1, -1))
        self._gbuf.zero_()
        self.stats["invalidation"] += n
        if _metrics_mod.enabled() and n:
            _M_EVENTS.inc(n, event="invalidation", table=str(self.table_id))
        return n

    def note_writeback(self, n: int):
        """Record an eviction write-back issued by the owning trainer."""
        self.stats["writeback"] += n
        if _metrics_mod.enabled() and n:
            _M_EVENTS.inc(n, event="writeback", table=str(self.table_id))

    def __len__(self) -> int:
        return len(self._slots)

    def hit_rate(self) -> float:
        tot = self.stats["hit"] + self.stats["miss"]
        return self.stats["hit"] / tot if tot else 0.0


def flush_all(caches) -> int:
    """Write back every cache's pending gradients: every gather is queued
    first, then each result comes to the host (one wait, not one a table).
    Returns total rows written back."""
    caches = [c for c in caches if len(c)]
    if not caches:
        return 0
    pending = [c._pending() for c in caches]
    gathered = [c._gbuf.index_select(0, slots)
                for c, (_, slots) in zip(caches, pending)]
    gathered = [g.cpu().numpy() for g in gathered]
    total = 0
    for c, (keys, _), g in zip(caches, pending, gathered):
        nz = np.any(g != 0.0, axis=1)
        n = int(nz.sum())
        if n:
            c.client.push_sparse(c.table_id, keys[nz], g[nz])
            c._written_back(n)
        total += n
    return total


def build_caches(embeddings, capacity: int, device=None
                 ) -> Dict[int, HotRowCache]:
    """One cache per DISTINCT cacheable table among `embeddings`, on
    ``device`` (``cuda`` unless the caller passes another); non-SGD tables
    are skipped with a warning (see CACHEABLE_OPTIMIZERS)."""
    caches: Dict[int, HotRowCache] = {}
    for e in embeddings:
        cfg = e._table_cfg
        if cfg.table_id in caches:
            continue
        if cfg.optimizer not in CACHEABLE_OPTIMIZERS:
            warnings.warn(
                f"hot-row cache skipped for table {cfg.table_id}: server "
                f"optimizer {cfg.optimizer!r} is not linear in the gradient "
                f"(cacheable: {CACHEABLE_OPTIMIZERS}); rows of this table "
                "keep the per-step pull/push path")
            continue
        # sum/geo tables: the server applies w += g (lr ignored), the
        # lr = -1 case of the SGD rule the cache computes on the card
        lr = -1.0 if cfg.optimizer in ("sum", "geo") else cfg.learning_rate
        caches[cfg.table_id] = HotRowCache(
            cfg.table_id, cfg.dim, capacity, lr, e.client, device=device)
    return caches


__all__ = ["HotRowCache", "CachePlan", "build_caches", "combine_batch",
           "apply_batch", "flush_all", "CACHEABLE_OPTIMIZERS"]
