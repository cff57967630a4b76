"""Async gradient communicator for PS training.

A copy of ``paddle_tpu/distributed/ps/communicator.py``. Paddle's C++
Communicator (``paddle/fluid/distributed/ps/service/communicator/
communicator.h:232`` — Async:402 / HalfAsync:492 / Sync:537): trainer-side
background threads batch gradients, merge duplicates, and push to the
servers off the critical path, which is where PS-mode's async speedup (and
its staleness) comes from.

This wraps `PSClient` with the same pull/push surface: pushes enqueue and a
sender thread merges per table — sparse grads segment-summed by key, dense
grads accumulated — and flushes every `send_wait_ms` or `merge_size`
pending pushes. Pulls pass through (reads see server state, i.e. slightly
stale during training, exactly the reference's async semantics).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from ...profiler import metrics as _metrics_mod

_REG = _metrics_mod.default_registry()
_H_SEND = _REG.histogram(
    "ps_comm_send_seconds",
    "communicator sender-thread drain latency (merged push RPC round)")
_M_MERGED = _REG.counter(
    "ps_comm_merged_rows_total",
    "sparse gradient rows merged by the communicator before pushing")


class Communicator:
    def __init__(self, client, merge_size: int = 8, send_wait_ms: int = 20,
                 queue_size: int = 1024):
        self._client = client
        self.merge_size = merge_size
        self.send_wait_ms = send_wait_ms
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._flush_done = threading.Event()
        self._error: Optional[BaseException] = None

    # -------------------------- lifecycle ---------------------------------
    def start(self):
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._send_loop, daemon=True)
        self._thread.start()

    def stop(self):
        if not self._running:
            return
        self.flush()
        self._running = False
        self._q.put(None)
        self._thread.join(timeout=10)

    def flush(self):
        """Block until everything enqueued so far reaches the servers."""
        if not self._running:
            return
        self._flush_done.clear()
        self._q.put("__flush__")
        while not self._flush_done.wait(timeout=1.0):
            if not self._thread.is_alive():  # belt-and-braces vs deadlock
                raise RuntimeError(
                    "PS communicator sender thread died unexpectedly")
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # --------------------------- push/pull --------------------------------
    def push_sparse(self, table_id: int, keys: np.ndarray,
                    grads: np.ndarray):
        self._check_error()
        self._q.put(("sparse", table_id, np.asarray(keys, np.uint64),
                     np.asarray(grads, np.float32)))

    def push_dense(self, table_id: int, grad: np.ndarray):
        self._check_error()
        self._q.put(("dense", table_id, np.asarray(grad, np.float32)))

    def _check_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def __getattr__(self, item):  # pulls, table mgmt, barriers: passthrough
        return getattr(self._client, item)

    # --------------------------- sender -----------------------------------
    def _send_loop(self):
        sparse: Dict[int, Dict[int, np.ndarray]] = {}  # tid -> key -> grad
        dense: Dict[int, np.ndarray] = {}
        pending = 0
        last_send = time.monotonic()

        def drain():
            nonlocal pending, last_send
            t0 = time.monotonic()
            merged_rows = 0
            ok = True
            try:
                for tid, merged in sparse.items():
                    if merged:
                        keys = np.fromiter(merged.keys(), np.uint64,
                                           len(merged))
                        grads = np.stack([merged[k] for k in keys])
                        self._client.push_sparse(tid, keys, grads)
                        merged_rows += keys.size
                for tid, g in dense.items():
                    self._client.push_dense(tid, g)
            except BaseException as e:  # surfaced on next push/flush
                self._error = e
                ok = False
            sparse.clear()
            dense.clear()
            pending = 0
            last_send = time.monotonic()
            # only a CLEAN round is recorded: counting rows from an
            # aborted push would show data flowing during an outage
            if ok and _metrics_mod.enabled() and merged_rows:
                _H_SEND.observe(time.monotonic() - t0)
                _M_MERGED.inc(merged_rows)

        while True:
            timeout = self.send_wait_ms / 1000.0
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                if pending:
                    drain()
                continue
            if item is None:
                drain()
                return
            if item == "__flush__":
                drain()
                self._flush_done.set()
                continue
            try:  # a bad item must not kill the thread: flush()/stop()
                # would then deadlock on _flush_done forever
                kind, tid = item[0], item[1]
                if kind == "sparse":
                    _, _, keys, grads = item
                    grads = grads.reshape(keys.size, -1)
                    bucket = sparse.setdefault(tid, {})
                    for k, g in zip(keys.tolist(), grads):
                        if k in bucket:
                            bucket[k] = bucket[k] + g
                        else:
                            bucket[k] = np.array(g, np.float32)
                else:
                    _, _, g = item
                    dense[tid] = dense.get(tid, 0) + g
                pending += 1
            except BaseException as e:
                self._error = e
                continue
            if pending >= self.merge_size:
                drain()


__all__ = ["Communicator"]


class GeoCommunicator:
    """Geo-SGD trainer-side communicator (reference GeoCommunicator,
    `ps/service/communicator/communicator.h:566` + server table
    `ps/table/memory_sparse_geo_table.cc`).

    Geo mode: each trainer trains against a LOCAL copy of the sparse table
    (optimizer applied locally, zero RPCs on the critical path); every
    `trainers * geo_need_push_nums`-ish steps it pushes the accumulated
    WEIGHT DELTA (w_local - w_base) to the server — whose table is created
    with optimizer="sum" so deltas from all trainers merge additively —
    and re-pulls the merged rows. Convergence is app-level eventual
    consistency: exactly the reference's trade of freshness for throughput.
    """

    def __init__(self, client, lr: float = 0.01, geo_push_steps: int = 8):
        self._client = client
        self.lr = lr
        self.geo_push_steps = geo_push_steps
        # table_id -> key -> (local_vec, base_vec)
        self._local: Dict[int, Dict[int, Tuple[np.ndarray, np.ndarray]]] = {}
        self._dirty: Dict[int, set] = {}
        self._push_counts: Dict[int, int] = {}
        self._ever_pushed: set = set()

    # ---------------- sparse path (local-first) ----------------------------
    def _materialize(self, table_id: int, keys: np.ndarray) -> dict:
        """Ensure every key has a local (value, base) pair; one batched RPC
        for the misses only. Returns the table's local dict."""
        tbl = self._local.setdefault(table_id, {})
        missing = [k for k in keys.tolist() if k not in tbl]
        if missing:
            vals = self._client.pull_sparse(
                table_id, np.asarray(missing, np.uint64))
            for k, v in zip(missing, vals):
                tbl[k] = (np.array(v, np.float32), np.array(v, np.float32))
        return tbl

    def pull_sparse(self, table_id: int, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, np.uint64).ravel()
        if keys.size == 0:
            return np.empty((0, self._client.table(table_id).dim), np.float32)
        tbl = self._materialize(table_id, keys)
        return np.stack([tbl[k][0] for k in keys.tolist()])

    def push_sparse(self, table_id: int, keys: np.ndarray,
                    grads: np.ndarray):
        """LOCAL SGD apply + delta bookkeeping; periodic delta push."""
        keys = np.asarray(keys, np.uint64).ravel()
        if keys.size == 0:
            return
        grads = np.asarray(grads, np.float32).reshape(keys.size, -1)
        tbl = self._materialize(table_id, keys)
        dirty = self._dirty.setdefault(table_id, set())
        for k, g in zip(keys.tolist(), grads):
            local, base = tbl[k]
            local -= self.lr * g
            dirty.add(k)
        # per-TABLE push counters: each table is pushed once per
        # training step, so geo_sync must fire every geo_push_steps STEPS,
        # not every geo_push_steps/num_tables push-calls (the reference
        # keeps per-variable send counters for the same reason). Trigger on
        # min over seen tables: the sync lands after the LAST table of a
        # step pushed, so no table's counter leads after the reset (a
        # max/any trigger drifts to steps 4,7,11,... for 2 tables). A table
        # pushed only in some steps delays the cadence accordingly.
        self._push_counts[table_id] = self._push_counts.get(table_id, 0) + 1
        # trigger on min over tables EVER pushed in this run:
        # at geo_push_steps=1 with multiple tables, min over merely-seen-
        # this-round tables fired after the FIRST table's push — mid-step.
        # Ever-pushed membership also keeps a registered-but-frozen table
        # (pull-only embedding) from suppressing the cadence; the one
        # artifact is that the very first sync of a run can land mid-step,
        # before later tables' first pushes are known. Counter resets keep
        # zeros for known tables, so steady state syncs on step boundaries.
        self._ever_pushed.add(table_id)
        counts = [self._push_counts.get(t, 0) for t in self._ever_pushed]
        # min-trigger keeps the sync on step boundaries; the max escape
        # hatch bounds staleness if some table stops being pushed (a frozen
        # counter would otherwise starve geo_sync forever)
        if (min(counts) >= self.geo_push_steps
                or max(counts) >= 2 * self.geo_push_steps):
            self.geo_sync()
            # forget tables that pushed nothing this round (frozen mid-run):
            # a permanent zero would pin min(counts)=0 and silently double
            # the cadence via the max escape for the rest of the run
            self._ever_pushed = {
                t for t in self._ever_pushed
                if self._push_counts.get(t, 0) > 0}
            self._push_counts = {}

    def geo_sync(self):
        """Push accumulated deltas, re-pull merged state (one geo round)."""
        for table_id, dirty in self._dirty.items():
            if not dirty:
                continue
            tbl = self._local[table_id]
            keys = np.asarray(sorted(dirty), np.uint64)
            deltas = np.stack([tbl[int(k)][0] - tbl[int(k)][1]
                               for k in keys.tolist()])
            self._client.push_sparse(table_id, keys, deltas)  # server: w += d
            merged = self._client.pull_sparse(table_id, keys)
            for k, v in zip(keys.tolist(), merged):
                tbl[k] = (np.array(v, np.float32), np.array(v, np.float32))
            dirty.clear()

    def flush(self):
        self.geo_sync()

    def stop(self):
        """Final teardown: land every accumulated delta on the servers."""
        self.geo_sync()

    # everything else (dense ops, tables, barriers) passes through
    def push_dense(self, table_id: int, grad: np.ndarray):
        self._client.push_dense(table_id, grad)

    def __getattr__(self, item):
        return getattr(self._client, item)


__all__ = ["Communicator", "GeoCommunicator"]
