"""PS client: shards requests across servers, exposes numpy in/out (a
copy of ``paddle_tpu/distributed/ps/client.py`` over the port's own host
library, ``_native/host.py``).

Paddle's `BrpcPsClient` (``paddle/fluid/distributed/ps/service/
brpc_ps_client.h:137`` — pull_dense/push_dense/pull_sparse/push_sparse
over brpc, feasigns sharded across servers). Sharding rule kept: feasign ->
server by key % n_servers; dense tables are placed on server
(table_id % n_servers). Every RPC retries under the port's
``fault.RetryPolicy`` at the fault site ``ps.<op>``.
"""
from __future__ import annotations

import ctypes
import os
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..._native import host as _host
from ...fault import RetryExhaustedError, RetryPolicy
from ...fault import site as _fault_site


class PSRequestError(RuntimeError):
    """A PS RPC failed every retry. Names the dead endpoint and table so an
    operator can tell WHICH server to look at (the reference's brpc client
    logs the channel address on `FLAGS_pserver_timeout_ms` exhaustion)."""

    def __init__(self, op: str, endpoint: str, table_id: int,
                 attempts: int, last: BaseException):
        super().__init__(
            f"PS request {op!r} to server {endpoint} (table {table_id}) "
            f"failed after {attempts} attempt(s): "
            f"{type(last).__name__}: {last}")
        self.op = op
        self.endpoint = endpoint
        self.table_id = table_id
        self.attempts = attempts
        self.last = last

_F32P = ctypes.POINTER(ctypes.c_float)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_I32P = ctypes.POINTER(ctypes.c_int32)

# "sum" = raw delta-merge (w += g) — the server side of geo-SGD
# (reference memory_sparse_geo_table.cc)
OPTIMIZERS = {"sgd": 0, "adagrad": 1, "adam": 2, "sum": 3, "geo": 3}

# per-request sparse batch budget (bytes of values); keeps every frame far
# under the transport's 256MB kMaxFrameLen regardless of caller batch size
_SPARSE_CHUNK_BYTES = 64 * 1024 * 1024


@dataclass
class TableConfig:
    """Mirror of the reference's TableParameter proto (the_one_ps.py Table)."""
    table_id: int
    kind: str = "sparse"          # "dense" | "sparse"
    dim: int = 8                  # embedding dim (sparse)
    dense_size: int = 0           # flat length (dense)
    optimizer: str = "sgd"
    learning_rate: float = 0.01
    init_range: float = 0.05
    seed: int = 0


class PSClient:
    def __init__(self, endpoints: Sequence[str], timeout_ms: int = 60000,
                 retry: Optional[RetryPolicy] = None,
                 pull_lanes: Optional[int] = None):
        if retry is None:
            retry = RetryPolicy.from_env(
                "PS", max_attempts=3, base_delay=0.1, max_delay=2.0)
        # never thread-abandon a native RPC (caller-supplied policies
        # included): an abandoned attempt keeps writing into the caller-
        # owned numpy buffer that its retry (and even the returned array)
        # also uses. Per-attempt deadlines belong to the transport's
        # timeout_ms, not the retry layer.
        if retry.attempt_timeout is not None:
            import copy
            import warnings
            warnings.warn(
                "PSClient ignores RetryPolicy.attempt_timeout (and "
                "PADDLE_TPU_PS_TIMEOUT): PS RPCs write caller-owned "
                "buffers and cannot be thread-abandoned; bound individual "
                "RPCs with PSClient(timeout_ms=...) instead")
            retry = copy.copy(retry)  # don't mutate the caller's policy
            retry.attempt_timeout = None
        self._retry = retry
        self._lib = _host.load()
        self._endpoints = list(endpoints)
        self._timeout_ms = timeout_ms
        self._handles: List[int] = []
        self._tables: Dict[int, TableConfig] = {}
        for ep in self._endpoints:
            host, port = ep.rsplit(":", 1)
            h = self._lib.ps_connect(host.encode(), int(port), timeout_ms)
            if h < 0:
                raise RuntimeError(f"PSClient: cannot connect to {ep}")
            self._handles.append(h)
        # extra "lane" connections for pull_sparse_multi: the native client
        # serializes requests per connection under a mutex, so overlapping
        # pulls across tables needs one connection set per concurrent lane
        # (the server spawns a thread per connection). Built lazily.
        if pull_lanes is None:
            from ...utils.envparse import env_int
            pull_lanes = env_int("PADDLE_TPU_PS_PULL_LANES", 4)
        self._max_pull_lanes = max(1, pull_lanes)
        self._lanes: List[List[int]] = []
        self._lane_lock = threading.Lock()
        self._lane_pool = None

    @property
    def num_servers(self) -> int:
        return len(self._handles)

    def _rpc(self, op: str, server_idx: int, table_id: int,
             call: Callable[[], int]):
        """Run one native RPC under retry+backoff with a fault site
        (`ps.<op>`); after exhaustion raise PSRequestError naming the dead
        endpoint. `call` returns the native rc (0 = ok). Pull/set calls
        rewrite the same buffer and are safe to replay; merge-style pushes
        are at-least-once under retry (the native transport fails before
        the server applies, so a replayed push did not apply the first
        time)."""
        def _do():
            _fault_site(f"ps.{op}")
            rc = call()
            if rc != 0:
                raise RuntimeError(f"{op} rpc returned {rc}")
        try:
            self._retry.call(_do, op=f"ps.{op}")
        except RetryExhaustedError as e:
            raise PSRequestError(op, self._endpoints[server_idx], table_id,
                                 e.attempts, e.last) from e

    def create_table(self, cfg: TableConfig):
        """Create on every server (idempotent server-side)."""
        kind = 0 if cfg.kind == "dense" else 1
        opt = OPTIMIZERS[cfg.optimizer]
        for h in self._handles:
            rc = self._lib.ps_create_table(
                h, cfg.table_id, kind, cfg.dim, cfg.dense_size, opt,
                cfg.learning_rate, cfg.init_range, cfg.seed)
            if rc != 0:
                raise RuntimeError(f"create_table({cfg.table_id}) failed")
        self._tables[cfg.table_id] = cfg

    def table(self, table_id: int) -> TableConfig:
        return self._tables[table_id]

    # ------------------------------ dense ---------------------------------

    def _dense_server(self, table_id: int):
        """(server_idx, handle) hosting a dense table — the one routing
        rule, shared by every dense op."""
        s = table_id % self.num_servers
        return s, self._handles[s]

    # dense tables of any size: transport in <=16M-float (64MB) chunks so
    # frames stay far under the 256MB transport cap
    _DENSE_CHUNK = 16 * 1024 * 1024

    def pull_dense(self, table_id: int) -> np.ndarray:
        cfg = self._tables[table_id]
        out = np.empty(cfg.dense_size, np.float32)
        s, h = self._dense_server(table_id)
        for off in range(0, cfg.dense_size, self._DENSE_CHUNK):
            ln = min(self._DENSE_CHUNK, cfg.dense_size - off)
            chunk = out[off:off + ln]
            self._rpc("pull_dense", s, table_id,
                      lambda: self._lib.ps_pull_dense(
                          h, table_id, chunk.ctypes.data_as(_F32P), off, ln))
        return out

    def push_dense(self, table_id: int, grad: np.ndarray):
        g = np.ascontiguousarray(grad, np.float32).ravel()
        s, h = self._dense_server(table_id)
        for off in range(0, g.size, self._DENSE_CHUNK):
            ln = min(self._DENSE_CHUNK, g.size - off)
            chunk = np.ascontiguousarray(g[off:off + ln])
            self._rpc("push_dense", s, table_id,
                      lambda: self._lib.ps_push_dense(
                          h, table_id, chunk.ctypes.data_as(_F32P), off, ln))

    def set_dense(self, table_id: int, values: np.ndarray):
        v = np.ascontiguousarray(values, np.float32).ravel()
        s, h = self._dense_server(table_id)
        for off in range(0, v.size, self._DENSE_CHUNK):
            ln = min(self._DENSE_CHUNK, v.size - off)
            chunk = np.ascontiguousarray(v[off:off + ln])
            self._rpc("set_dense", s, table_id,
                      lambda: self._lib.ps_set_dense(
                          h, table_id, chunk.ctypes.data_as(_F32P), off, ln))

    # ------------------------------ sparse --------------------------------

    def _shard_indices(self, keys: np.ndarray):
        """Yield (server_idx, positions) for the keys%num_servers routing
        shared by every sparse op. positions is None for the single-server
        fast path (callers use the arrays directly, no fancy-index copies).
        """
        ns = self.num_servers
        if ns == 1:
            yield 0, None
            return
        shard = (keys % np.uint64(ns)).astype(np.int64)
        for s in range(ns):
            idx = np.nonzero(shard == s)[0]
            if idx.size:
                yield s, idx

    def pull_sparse(self, table_id: int, keys: np.ndarray,
                    handles: Optional[List[int]] = None) -> np.ndarray:
        """keys: uint64 [n] -> values float32 [n, dim]."""
        cfg = self._tables[table_id]
        keys = np.ascontiguousarray(keys, np.uint64).ravel()
        out = np.empty((keys.size, cfg.dim), np.float32)
        if keys.size == 0:
            return out
        for s, idx in self._shard_indices(keys):
            if idx is None:
                self._pull_shard(s, table_id, keys, out, handles)
                continue
            part = np.empty((idx.size, cfg.dim), np.float32)
            self._pull_shard(s, table_id, np.ascontiguousarray(keys[idx]),
                             part, handles)
            out[idx] = part
        return out

    # -------------------- overlapped multi-table pull -----------------------

    def _ensure_lanes(self, n: int) -> int:
        """Grow the lane-connection pool to min(n, max_pull_lanes) lanes;
        returns the usable lane count. Lane 0 reuses the primary handles."""
        n = min(max(n, 1), self._max_pull_lanes)
        with self._lane_lock:
            if not self._lanes:
                self._lanes.append(self._handles)
            while len(self._lanes) < n:
                lane = []
                for ep in self._endpoints:
                    host, port = ep.rsplit(":", 1)
                    h = self._lib.ps_connect(host.encode(), int(port),
                                             self._timeout_ms)
                    if h < 0:  # degraded server: fall back to fewer lanes
                        lane = None
                        break
                    lane.append(h)
                if lane is None:
                    # cap at what we achieved and STOP trying: there is no
                    # native disconnect, so re-attempting on every pull
                    # would strand one handle per healthy endpoint per
                    # step and pay blocking connects on the prepare stage
                    self._max_pull_lanes = len(self._lanes)
                    break
                self._lanes.append(lane)
            if self._lane_pool is None and len(self._lanes) > 1:
                import concurrent.futures
                self._lane_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=self._max_pull_lanes,
                    thread_name_prefix="ps-pull-lane")
            return len(self._lanes)

    def pull_sparse_multi(
            self, requests: Sequence[Tuple[int, np.ndarray]]
    ) -> List[np.ndarray]:
        """Pull several tables' rows in ONE overlapped RPC round.

        `requests` is a sequence of ``(table_id, keys)``; the result list
        matches it by position. Each concurrent request runs over its own
        lane connection (the per-connection mutex in the native client —
        and the blocking socket under it — would serialize them otherwise),
        so the wall cost is one round trip, not ``len(requests)``. The
        per-RPC retry/fault-site machinery (`ps.pull_sparse`) applies
        unchanged on every lane."""
        reqs = [(tid, np.ascontiguousarray(k, np.uint64).ravel())
                for tid, k in requests]
        live = [i for i, (_, k) in enumerate(reqs) if k.size]
        if len(live) <= 1:
            return [self.pull_sparse(tid, k) for tid, k in reqs]
        lanes = self._ensure_lanes(len(live))
        if lanes <= 1 or self._lane_pool is None:
            return [self.pull_sparse(tid, k) for tid, k in reqs]
        out: List[Optional[np.ndarray]] = [
            None if i in set(live) else self.pull_sparse(*reqs[i])
            for i in range(len(reqs))]
        futs = {}
        for j, i in enumerate(live):
            tid, k = reqs[i]
            futs[i] = self._lane_pool.submit(
                self.pull_sparse, tid, k, self._lanes[j % lanes])
        for i, f in futs.items():
            out[i] = f.result()
        return out

    def _sparse_chunk(self, dim: int) -> int:
        return max(1, _SPARSE_CHUNK_BYTES // max(dim * 4, 16))

    def _pull_shard(self, s: int, table_id: int, keys: np.ndarray,
                    out: np.ndarray, handles: Optional[List[int]] = None):
        h = (handles or self._handles)[s]
        step = self._sparse_chunk(out.shape[1] if out.ndim > 1 else 1)
        for i in range(0, keys.size, step):
            k = keys[i:i + step]
            o = out[i:i + step]
            self._rpc("pull_sparse", s, table_id,
                      lambda: self._lib.ps_pull_sparse(
                          h, table_id,
                          k.ctypes.data_as(_U64P), k.size,
                          o.ctypes.data_as(_F32P), o.size))

    def push_sparse(self, table_id: int, keys: np.ndarray, grads: np.ndarray):
        """keys uint64 [n], grads float32 [n, dim]."""
        keys = np.ascontiguousarray(keys, np.uint64).ravel()
        grads = np.ascontiguousarray(grads, np.float32).reshape(keys.size, -1)
        if keys.size == 0:
            return
        for s, idx in self._shard_indices(keys):
            if idx is None:
                self._push_shard(s, table_id, keys, grads)
                continue
            self._push_shard(s, table_id, np.ascontiguousarray(keys[idx]),
                             np.ascontiguousarray(grads[idx]))

    def _push_shard(self, s: int, table_id: int, keys: np.ndarray,
                    grads: np.ndarray):
        step = self._sparse_chunk(grads.shape[1] if grads.ndim > 1 else 1)
        for i in range(0, keys.size, step):
            k = np.ascontiguousarray(keys[i:i + step])
            g = np.ascontiguousarray(grads[i:i + step])
            self._rpc("push_sparse", s, table_id,
                      lambda: self._lib.ps_push_sparse(
                          self._handles[s], table_id,
                          k.ctypes.data_as(_U64P), k.size,
                          g.ctypes.data_as(_F32P), g.size))

    # -------------------- CTR lifecycle (ctr_accessor) ---------------------

    def push_show_click(self, table_id: int, keys: np.ndarray,
                        shows: np.ndarray, clicks: np.ndarray):
        """Accumulate impression/click counters on sparse rows (reference
        CtrCommonAccessor: show/click feed the eviction score)."""
        keys = np.ascontiguousarray(keys, np.uint64).ravel()
        shows = np.ascontiguousarray(shows, np.float32).ravel()
        clicks = np.ascontiguousarray(clicks, np.float32).ravel()
        for s, idx in self._shard_indices(keys):
            if idx is None:
                k, sh, cl = keys, shows, clicks
            else:
                k = np.ascontiguousarray(keys[idx])
                sh = np.ascontiguousarray(shows[idx])
                cl = np.ascontiguousarray(clicks[idx])
            step = self._sparse_chunk(4)
            for i in range(0, k.size, step):
                ks = np.ascontiguousarray(k[i:i + step])
                rc = self._lib.ps_push_show_click(
                    self._handles[s], table_id,
                    ks.ctypes.data_as(_U64P), ks.size,
                    np.ascontiguousarray(sh[i:i + step]).ctypes.data_as(_F32P),
                    np.ascontiguousarray(cl[i:i + step]).ctypes.data_as(_F32P))
                if rc != 0:
                    raise RuntimeError(f"push_show_click({table_id}) failed")

    def register_row_cache(self, cache):
        """Register a device-side hot-row cache serving one of this
        client's tables (`distributed/ps/cache.py` does this at
        construction), so server-side lifecycle operations that evict
        rows — `shrink()` — can flush + invalidate it. Held by weakref:
        a dropped cache unregisters itself."""
        import weakref
        if not hasattr(self, "_row_caches"):
            self._row_caches = []
        self._row_caches.append(weakref.ref(cache))

    def _table_caches(self, table_id: int):
        out = []
        for ref in list(getattr(self, "_row_caches", ())):
            c = ref()
            if c is None:
                self._row_caches.remove(ref)
            elif c.table_id == int(table_id):
                out.append(c)
        return out

    def shrink(self, table_id: int, threshold: float = 0.0,
               max_unseen_days: int = 7) -> int:
        """One day-tick: decay show/click, age rows, evict below-threshold
        stale rows on every server. Returns total evicted rows.

        Device hot-row caches registered for this table are part of the
        lifecycle: their pending gradients are FLUSHED first (so the
        eviction decision sees fully-accounted rows, and no post-shrink
        write-back can resurrect an evicted key), then — after the
        server-side eviction — every cached row is INVALIDATED. Without
        this, a shrunk row would stay device-resident and be served stale on
        every later hit. Call shrink at
        a step boundary with no planned-but-undispatched batch in flight
        (pipelined heter trainers: `HeterPSTrainStep.flush()` first) —
        a cache plan computed before the invalidation must not be
        committed after it."""
        caches = self._table_caches(table_id)
        for c in caches:
            c.flush()
        total = 0
        for h in self._handles:
            n = self._lib.ps_shrink(h, table_id, float(threshold),
                                    int(max_unseen_days))
            if n < 0:
                raise RuntimeError(f"shrink({table_id}) failed")
            total += int(n)
        for c in caches:
            c.invalidate()
        return total

    def pull_meta(self, table_id: int, keys: np.ndarray):
        """Per-key (show, click, unseen_days); unseen_days=-1 if evicted."""
        keys = np.ascontiguousarray(keys, np.uint64).ravel()
        n = keys.size
        show = np.empty(n, np.float32)
        click = np.empty(n, np.float32)
        unseen = np.empty(n, np.int32)
        for s, idx in self._shard_indices(keys):
            if idx is None:
                k, sh, cl, un = keys, show, click, unseen
            else:
                k = np.ascontiguousarray(keys[idx])
                sh = np.empty(idx.size, np.float32)
                cl = np.empty(idx.size, np.float32)
                un = np.empty(idx.size, np.int32)
            step = self._sparse_chunk(4)
            for i in range(0, k.size, step):
                ks = np.ascontiguousarray(k[i:i + step])
                rc = self._lib.ps_pull_meta(
                    self._handles[s], table_id, ks.ctypes.data_as(_U64P),
                    ks.size, sh[i:i + step].ctypes.data_as(_F32P),
                    cl[i:i + step].ctypes.data_as(_F32P),
                    un[i:i + step].ctypes.data_as(_I32P))
                if rc != 0:
                    raise RuntimeError(f"pull_meta({table_id}) failed")
            if idx is not None:
                show[idx], click[idx], unseen[idx] = sh, cl, un
        return show, click, unseen

    # -------------------- graph tables (common_graph_table) ----------------

    def graph_add_edges(self, table_id: int, src: np.ndarray,
                        dst: np.ndarray, weights=None):
        """Append directed edges (reference common_graph_table.cc): nodes
        shard across servers by src id; weights default to 1."""
        src = np.ascontiguousarray(src, np.uint64).ravel()
        dst = np.ascontiguousarray(dst, np.uint64).ravel()
        w = (None if weights is None
             else np.ascontiguousarray(weights, np.float32).ravel())
        step = _SPARSE_CHUNK_BYTES // 20  # 8+8+4 bytes per edge
        for s, idx in self._shard_indices(src):
            ks = src if idx is None else np.ascontiguousarray(src[idx])
            kd = dst if idx is None else np.ascontiguousarray(dst[idx])
            kw = (None if w is None else
                  (w if idx is None else np.ascontiguousarray(w[idx])))
            for i in range(0, ks.size, step):
                cs = np.ascontiguousarray(ks[i:i + step])
                cd = np.ascontiguousarray(kd[i:i + step])
                cw = (None if kw is None
                      else np.ascontiguousarray(kw[i:i + step]))
                rc = self._lib.ps_graph_add_edges(
                    self._handles[s], table_id, cs.ctypes.data_as(_U64P),
                    cd.ctypes.data_as(_U64P),
                    (cw.ctypes.data_as(_F32P) if cw is not None
                     else ctypes.cast(None, _F32P)), cs.size)
                if rc != 0:
                    raise RuntimeError(
                        f"graph_add_edges({table_id}) failed")

    def graph_sample_neighbors(self, table_id: int, nodes: np.ndarray,
                               k: int, seed: int = 0):
        """Sample up to k neighbors per node (weight-proportional without
        replacement; all neighbors when degree <= k). Returns (neighbors
        [n, k] uint64 padded with 0, counts [n] int32)."""
        nodes = np.ascontiguousarray(nodes, np.uint64).ravel()
        n = nodes.size
        counts = np.zeros(n, np.int32)
        padded = np.zeros((n, max(k, 1)), np.uint64)
        step = max(1, _SPARSE_CHUNK_BYTES // (12 + 8 * max(k, 1)))
        for s, idx in self._shard_indices(nodes):
            ks = nodes if idx is None else np.ascontiguousarray(nodes[idx])
            cc = np.zeros(ks.size, np.int32)
            rows = np.zeros((ks.size, max(k, 1)), np.uint64)
            for i0 in range(0, ks.size, step):
                chunk = np.ascontiguousarray(ks[i0:i0 + step])
                c_chunk = np.zeros(chunk.size, np.int32)
                flat = np.zeros(chunk.size * max(k, 1), np.uint64)
                total = self._lib.ps_graph_sample(
                    self._handles[s], table_id, chunk.ctypes.data_as(_U64P),
                    chunk.size, int(k), int(seed),
                    c_chunk.ctypes.data_as(_I32P),
                    flat.ctypes.data_as(_U64P))
                if total < 0:
                    raise RuntimeError(f"graph_sample({table_id}) failed")
                pos = 0
                for i, c_ in enumerate(c_chunk):
                    rows[i0 + i, :c_] = flat[pos:pos + c_]
                    pos += int(c_)
                cc[i0:i0 + chunk.size] = c_chunk
            if idx is None:
                counts, padded = cc, rows
            else:
                counts[idx] = cc
                padded[idx] = rows
        return padded, counts

    def graph_khop_sample(self, table_id: int, nodes: np.ndarray,
                          sample_sizes, seed: int = 0):
        """Multi-hop neighbor sampling (reference graph service khop, the
        server-side counterpart of incubate.graph_khop_sampler): hop i
        samples `sample_sizes[i]` neighbors of the previous frontier.
        Returns a list of (neighbors [n_i, k_i] uint64, counts [n_i] int32,
        frontier [n_i] uint64) per hop; the next frontier is the unique set
        of sampled neighbors."""
        frontier = np.ascontiguousarray(nodes, np.uint64).ravel()
        hops = []
        for hop, k in enumerate(sample_sizes):
            nb, cnt = self.graph_sample_neighbors(
                table_id, frontier, int(k), seed=seed + hop)
            hops.append((nb, cnt, frontier))
            if cnt.sum() == 0:
                break
            mask = np.arange(nb.shape[1]) < cnt[:, None]
            frontier = np.unique(nb[mask])
            if frontier.size == 0:
                break
        return hops

    def graph_degree(self, table_id: int, nodes: np.ndarray) -> np.ndarray:
        nodes = np.ascontiguousarray(nodes, np.uint64).ravel()
        out = np.zeros(nodes.size, np.int64)
        step = _SPARSE_CHUNK_BYTES // 16
        for s, idx in self._shard_indices(nodes):
            ks = nodes if idx is None else np.ascontiguousarray(nodes[idx])
            dd = np.zeros(ks.size, np.int64)
            for i in range(0, ks.size, step):
                chunk = np.ascontiguousarray(ks[i:i + step])
                rc = self._lib.ps_graph_degree(
                    self._handles[s], table_id, chunk.ctypes.data_as(_U64P),
                    chunk.size,
                    dd[i:i + step].ctypes.data_as(
                        ctypes.POINTER(ctypes.c_int64)))
                if rc != 0:
                    raise RuntimeError(f"graph_degree({table_id}) failed")
            if idx is None:
                out = dd
            else:
                out[idx] = dd
        return out

    # -------------------- disk spill (ssd_sparse_table) --------------------

    def set_spill(self, table_id: int, dirname: str):
        """Enable disk spill for a sparse table: cold rows move to an
        append-only file per server, RAM keeps a key->offset index
        (reference ps/table/ssd_sparse_table.cc over rocksdb)."""
        import os
        os.makedirs(dirname, exist_ok=True)
        for i, h in enumerate(self._handles):
            path = os.path.join(dirname, f"spill_{table_id}_srv{i}.bin")
            if self._lib.ps_set_spill(h, table_id, path.encode()) != 0:
                raise RuntimeError(f"set_spill({table_id}) failed")

    def spill_cold(self, table_id: int, max_unseen_days: int = 1) -> int:
        """Move rows unseen for more than N day-ticks to disk; they restore
        transparently on next pull/push. Returns rows spilled.

        `shrink()` owns the day tick — spill_cold only COMPARES the age, so
        daily maintenance pairs them: `shrink(tid, thr, evict_days)` then
        `spill_cold(tid, spill_days)`. For spill-only maintenance use an
        age-only shrink (negative threshold evicts nothing but ages)."""
        total = 0
        for h in self._handles:
            n = self._lib.ps_spill_cold(h, table_id, int(max_unseen_days))
            if n < 0:
                raise RuntimeError(f"spill_cold({table_id}) failed "
                                   "(set_spill first?)")
            total += int(n)
        return total

    def spilled_size(self, table_id: int) -> int:
        return sum(int(self._lib.ps_spilled_size(h, table_id))
                   for h in self._handles)

    # ------------------------- control plane ------------------------------

    def table_size(self, table_id: int) -> int:
        return sum(self._lib.ps_table_size(h, table_id) for h in self._handles)

    def save(self, dirname: str):
        import os
        for i, h in enumerate(self._handles):
            d = os.path.join(dirname, f"server_{i}")
            os.makedirs(d, exist_ok=True)
            if self._lib.ps_save(h, d.encode()) != 0:
                raise RuntimeError("ps save failed")

    def load(self, dirname: str):
        import os
        for i, h in enumerate(self._handles):
            d = os.path.join(dirname, f"server_{i}")
            if self._lib.ps_load(h, d.encode()) != 0:
                raise RuntimeError("ps load failed")

    def barrier(self, name: str, world: int):
        """Barrier across `world` participants, coordinated by server 0."""
        if self._lib.ps_barrier(self._handles[0], name.encode(), world) != 0:
            raise RuntimeError("ps barrier failed")

    def stop_servers(self):
        for h in self._handles:
            self._lib.ps_stop_server(h)
