"""Heterogeneous PS training: host-side sparse PS + one captured dense step
on the card (counterpart of ``paddle_tpu/distributed/ps/heter.py``).

Paddle's heterogeneous trainer family — an accelerator dense net with
sparse embedding pull/push against the CPU parameter server
(``paddle/fluid/framework/fleet/heter_ps/``,
``ps/service/heter_client.cc``, ``HeterPipelineTrainer`` in
``framework/trainer.h:336``).

Per step:

1. **route** — the layer runs once through ``functional_call`` with
   ``meta`` parameters, ``meta`` buffers and ``meta`` floating inputs,
   while the integer inputs stay concrete on the host: each
   `SparseEmbedding` records the ids it receives and returns ``meta``
   zeros. Nothing is launched on the card and no dense value is computed,
   so any id routing that is a function of the batch (slicing, reshapes,
   concat) is captured without a per-model protocol. It runs every step,
   so a batch-shape change is seen at once.
2. **pull (host)** — per embedding call: np.unique over the ids, then ONE
   overlapped multi-table RPC round (`PSClient.pull_sparse_multi`) for
   every table's unique rows, padded to a power-of-two bucket (which
   bounds the number of captured graphs; the padded tail is never
   addressed by ``inverse``). With the hot-row cache on, only cache MISSES
   ride the RPC and hits are gathered on the card (`cache.py`). The rows,
   the inverses, the cache's index maps and the batch go to the card from
   pinned host memory on a side stream, with an event.
3. **dense step (device)** — the model runs with each embedding reading
   ``rows[inverse]``; autograd differentiates the loss with respect to the
   dense parameters AND the pulled rows (leaf tensors) — the gather's
   backward IS the duplicate-merging segment-sum, so each row gradient
   comes back merged per unique key. The optimizer's ``apply_fn`` updates
   the parameters and its slots in place. On a card this step is one CUDA
   graph per (batch signature, tuple of padded-unique buckets)
   (``jit.graphs.StepGraphs``, as ``jit.TrainStep``): each call copies the
   bundle's rows, inverses and batch into the graph's static inputs on the
   main thread's stream and replays. On the CPU the same step runs
   uncaptured.
4. **push (host)** — the first n_unique row gradients go to the host
   (pinned, after the step's event) and back to the PS with one
   `push_sparse` RPC per non-cached table; cached tables absorb gradients
   on the card and write back on eviction/flush (server-side SGD is linear
   in the gradient, so the deferred push is equivalent — see cache.py).

Three modes (paddle's sync vs a_sync trainers,
``ps/service/communicator/communicator.h:402,537``, plus the heter
pipeline trainer's stage threads, ``framework/trainer.h:336``):

- ``mode="sync"`` (default) — each step's pushes land before the next
  step's pulls; loss-for-loss what the eager PS loop gives. The host waits
  for the row gradients at the end of every step.
- ``mode="async"`` — the push RPC and its gradient transfer run on a
  worker thread while the card executes the next step. Pulls may miss the
  single outstanding push (staleness <= 1 step). Call :meth:`flush` before
  reading final state.
- ``mode="pipelined"`` — route, unique, pull and the host-to-device copy
  run as a background *prepare* stage on a prefetch thread while the card
  executes the previous step, and the push stage runs on a second worker
  thread. Callers that know the next batch hand it to :meth:`prefetch`
  right after a step, so the prepare stage runs one batch ahead. The
  staleness contract is that of async — a pull may miss at most the ONE
  in-flight push (the previous step's): outstanding push futures are
  drained before a new prepare may pull (for a ``prefetch()``-issued
  prepare the wait is chained onto the prefetch thread, so ``prefetch()``
  itself never blocks), so pulls for step *t* always observe pushes
  through step *t-2*. The copies into a graph's static inputs are made on
  the main thread at dispatch, never from the prefetch thread, so they
  stay in order with the replays.

Pipeline-stage failures go through the port's `RetryPolicy` with the fault
sites ``heter.pull`` / ``heter.push`` (knobs ``PADDLE_TPU_HETER_*``) ON TOP
of the per-RPC retry inside `PSClient`, so a mid-pipeline PS hiccup retries
the stage instead of wedging the prefetch thread; exhaustion surfaces on
the main thread at the next step.

Stage latencies land in the metrics registry as histograms
(``heter_route_seconds`` / ``heter_pull_seconds`` / ``heter_push_seconds``
/ ``heter_step_wall_seconds``) and cumulative per-stage seconds are on
:attr:`stage_totals` (``route_s``, ``pull_s``, ``put_s`` (the host-to-device
stage), ``push_s``, ``steps``, as in the reference; and ``plan_s``, the
unique and cache planning between route and pull, and ``dispatch_s``, the
main thread's dispatch: combine, the dense step and the cache's apply).
"""
from __future__ import annotations

import sys
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ...fault import RetryPolicy
from ...fault import site as _fault_site
from ...jit import _signature, functionalize
from ...jit.graphs import StepGraphs
from ...profiler import metrics as _metrics_mod

_ROUTE = threading.local()  # .capture: list appended by SparseEmbedding
_FEED = threading.local()   # .queue: per-call {"rows", "inverse"} feeds

_REG = _metrics_mod.default_registry()
_H_ROUTE = _REG.histogram("heter_route_seconds",
                          "heter-PS id-routing stage latency")
_H_PULL = _REG.histogram("heter_pull_seconds",
                         "heter-PS sparse pull stage latency (RPC round)")
_H_PUSH = _REG.histogram("heter_push_seconds",
                         "heter-PS sparse push stage latency (incl. D2H)")
_H_STEP = _REG.histogram(
    "heter_step_wall_seconds",
    "heter-PS per-step wall time on the main thread, by mode")


def _capturing() -> Optional[list]:
    return getattr(_ROUTE, "capture", None)


def _feeding() -> Optional[list]:
    return getattr(_FEED, "queue", None)


def _bucket(n: int, minimum: int = 64) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclass
class _Call:
    """One SparseEmbedding call's prepared sparse inputs for a step."""
    emb: object
    uniq: np.ndarray
    cache: object = None           # HotRowCache or None
    cplan: object = None           # CachePlan (cache path only)
    plan_dev: tuple = None         # (slot_idx, hit_mask, miss_idx) on device
    evict_keys: Optional[np.ndarray] = None
    evict_slots_dev: object = None


@dataclass
class _Bundle:
    """Output of the prepare stage: everything the dispatch needs, on the
    step's device (``event``: the side stream's copies, or None)."""
    arrs: tuple                     # the batch on the step's device
    calls: List[_Call]
    rows: tuple                     # per-call padded rows (misses, or the
                                    # full bucket for uncached tables)
    invs: tuple
    event: object = None


class _HostRows:
    """Row gradients on their way to the host: pinned copies issued on the
    step's stream, and the event after them (None on the CPU)."""

    def __init__(self, rows, event=None):
        self.rows, self.event = rows, event

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
        return [r.numpy() for r in self.rows]


def _to_host(tensors) -> _HostRows:
    if not tensors or tensors[0].device.type != "cuda":
        return _HostRows([t.detach() for t in tensors])
    out = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        out.append(h)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(tensors[0].device))
    return _HostRows(out, event)


class HeterPSTrainStep:
    """Dense-net training on the card around a live parameter server.

    `model` may contain any number of `SparseEmbedding` layers (tables on
    the PS, no local params) plus ordinary dense layers; `optimizer` only
    ever sees the dense params — sparse updates run server-side, as in
    paddle's DownpourWorker split.

    donate: taken in the reference's slot and not used (the reference
    donates its state buffers to the compiled step).

    ``cache_capacity`` > 0 enables the device-side hot-row cache
    (`cache.py`) for every SGD-family sparse table: high-skew id
    distributions then skip the PS round trip on hits.

    The step runs on the device of the model's parameters. ``stats``
    counts graph captures and replays (zeros on the CPU).
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 donate: bool = True, mode: str = "sync",
                 cache_capacity: int = 0):
        from .embedding import SparseEmbedding

        assert mode in ("sync", "async", "pipelined"), mode
        self.layer = model
        self.mode = mode
        self._loss_fn = loss_fn
        self._pending = None  # overlapped modes: (grows, push_meta) to push
        self._push_futs: list = []
        self._push_pool = None  # lazy single worker: pushes stay ordered
        self._prefetch_pool = None  # pipelined: single prepare worker
        self._prefetched = None     # (batch, future) queued by prefetch()
        self._stage_retry = RetryPolicy.from_env(
            "HETER", max_attempts=3, base_delay=0.05, max_delay=1.0)
        self.stage_totals: Dict[str, float] = {
            "route_s": 0.0, "pull_s": 0.0, "put_s": 0.0, "push_s": 0.0,
            "plan_s": 0.0, "dispatch_s": 0.0, "steps": 0}
        self._totals_lock = threading.Lock()
        self.optimizer = optimizer
        self._embeddings: List[SparseEmbedding] = [
            m for _, m in model.named_modules()
            if isinstance(m, SparseEmbedding)]
        assert self._embeddings, (
            "HeterPSTrainStep needs at least one SparseEmbedding; use "
            "jit.TrainStep for fully-dense models")
        for e in self._embeddings:
            e._ensure_table()
        self.apply_fn, params, buffers = functionalize(model)
        self.params = {k: p.detach().clone().requires_grad_(True)
                       for k, p in params.items()}
        self.buffers = {k: b.detach().clone() for k, b in buffers.items()}
        self._names = list(self.params)
        self.device = (next(iter(self.params.values())).device
                       if self.params else self._embeddings[0]._device)
        self._caches: Dict[int, object] = {}
        if cache_capacity:
            from .cache import build_caches
            self._caches = build_caches(self._embeddings, cache_capacity,
                                        device=self.device)
        self.opt_state = optimizer.init_state_tree(self.params)
        self._t = 0
        # the update's scalars, filled before every step
        self._lr = torch.zeros((), dtype=torch.float64, device=self.device)
        self._step_t = torch.zeros((), dtype=torch.float64,
                                   device=self.device)
        cuda = self.device.type == "cuda"
        self._graphs = StepGraphs(self.device, "HeterPSTrainStep") \
            if cuda else None
        self._static: dict = {}  # graph key -> (rows, invs, batch) inputs
        self._h2d_stream = torch.cuda.Stream(self.device) if cuda else None
        # the routing pass's stand-ins: meta tensors of the state's shapes
        self._meta_state = {
            k: torch.empty_like(v, device="meta")
            for k, v in {**self.params, **self.buffers}.items()}

    @property
    def caches(self) -> Dict[int, object]:
        return self._caches

    @property
    def stats(self) -> dict:
        """{"graph_captures", "graph_replays" ({key: replays}),
        "graph_pool_bytes"}; zeros on the CPU."""
        g = self._graphs
        return {"graph_captures": g.captures if g else 0,
                "graph_replays": dict(g.replays) if g else {},
                "graph_pool_bytes": g.pool_bytes if g else 0}

    # -- id routing ---------------------------------------------------------
    def _route(self, arrs):
        """Map the batch to each SparseEmbedding call's concrete ids (host
        int64 arrays) and (embedding, ids shape) per call. Floating inputs
        become ``meta`` tensors, integer ones host tensors; the layer runs
        on ``meta`` stand-ins of the parameters and buffers, so nothing
        reaches the card."""
        inputs = tuple(
            torch.empty(a.shape, dtype=a.dtype, device="meta")
            if a.is_floating_point() else a.cpu() for a in arrs[:-1])
        _ROUTE.capture, _ROUTE.plan = [], []
        try:
            with torch.no_grad():
                self.apply_fn(self._meta_state, {}, *inputs)
            ids, plan = _ROUTE.capture, _ROUTE.plan
        finally:
            _ROUTE.capture = _ROUTE.plan = None
        assert plan and len(ids) == len(plan), (
            "id routing captured no SparseEmbedding calls — does the "
            "model's forward reach its embeddings?")
        return [t.numpy() for t in ids], plan

    # -- prepare stage (route + unique + pull + H2D) ------------------------
    def _drop_shared_caches(self, plan):
        """A table consumed by MORE THAN ONE embedding call per step cannot
        be cached: each call's plan() would start from the same committed
        index and hand the same slots to different keys. Such tables'
        caches are flushed and dropped; their rows go back to the per-step
        pull/push path."""
        seen, dups = set(), set()
        for emb, _ in plan:
            tid = emb._table_cfg.table_id
            (dups if tid in seen else seen).add(tid)
        for tid in dups:
            dropped = self._caches.pop(tid, None)
            if dropped is not None:
                dropped.flush()
                warnings.warn(
                    f"hot-row cache disabled for table {tid}: it is "
                    "consumed by multiple embedding calls in one step "
                    "(per-step cache plans would collide); this "
                    "table's rows use the per-step pull/push path")

    def _prepare(self, arrs) -> _Bundle:
        """Stage 1 of the pipeline. Runs on the prefetch thread in
        pipelined mode, inline otherwise; touches NO cache device state and
        commits no cache index mutations (those happen at dispatch on the
        main thread), so an abandoned bundle is side-effect-free."""
        record = _metrics_mod.enabled()
        t0 = time.perf_counter()
        ids_host, plan = self._route(arrs)
        route_s = time.perf_counter() - t0
        if self._caches:
            self._drop_shared_caches(plan)

        t_plan = time.perf_counter()
        calls: List[_Call] = []
        inv_list: List[np.ndarray] = []
        pull_reqs = []  # (client, table_id, keys) in call order
        for ids, (emb, _shape) in zip(ids_host, plan):
            flat = np.asarray(ids).reshape(-1).astype(np.uint64)
            uniq, inverse = np.unique(flat, return_inverse=True)
            inv_list.append(inverse.reshape(-1).astype(np.int64))
            cache = self._caches.get(emb._table_cfg.table_id)
            if cache is None:
                calls.append(_Call(emb=emb, uniq=uniq))
                pull_reqs.append((emb.client, emb._table_cfg.table_id, uniq))
            else:
                cplan = cache.plan(uniq, _bucket(uniq.size))
                calls.append(_Call(emb=emb, uniq=uniq, cache=cache,
                                   cplan=cplan))
                pull_reqs.append((emb.client, emb._table_cfg.table_id,
                                  cplan.miss_keys))

        t1 = time.perf_counter()
        plan_s = t1 - t_plan
        pulled = self._stage_retry.call(
            self._pull_round, pull_reqs, op="heter.pull")
        pull_s = time.perf_counter() - t1

        t2 = time.perf_counter()
        host: list = []  # every array that goes to the device, in order
        for c, rows in zip(calls, pulled):
            if c.cache is None:
                rows_p = np.zeros((_bucket(c.uniq.size), c.emb._dim),
                                  np.float32)
                rows_p[:c.uniq.size] = rows
                host.append(rows_p)
            else:
                p = c.cplan
                rows_p = np.zeros((_bucket(len(p.miss_keys), minimum=8),
                                   c.emb._dim), np.float32)
                rows_p[:len(p.miss_keys)] = rows
                host += [rows_p, p.slot_idx, p.hit_mask, p.miss_idx]
                if p.evicts:
                    c.evict_keys = np.asarray([k for k, _ in p.evicts],
                                              np.uint64)
                    host.append(np.asarray([s for _, s in p.evicts],
                                           np.int64))
        host += inv_list
        dev, event = self._to_device([torch.from_numpy(h) for h in host]
                                     + list(arrs))
        it = iter(dev)
        rows_dev = []
        for c in calls:
            rows_dev.append(next(it))
            if c.cache is not None:
                c.plan_dev = (next(it), next(it), next(it))
                if c.evict_keys is not None:
                    c.evict_slots_dev = next(it)
        invs_dev = tuple(next(it) for _ in inv_list)
        arrs_dev = tuple(it)
        put_s = time.perf_counter() - t2

        if record:
            _H_ROUTE.observe(route_s)
            _H_PULL.observe(pull_s)
        with self._totals_lock:
            self.stage_totals["route_s"] += route_s
            self.stage_totals["pull_s"] += pull_s
            self.stage_totals["put_s"] += put_s
            self.stage_totals["plan_s"] += plan_s
        return _Bundle(arrs=arrs_dev, calls=calls, rows=tuple(rows_dev),
                       invs=invs_dev, event=event)

    def _to_device(self, tensors):
        """Host tensors to the step's device: on a card through pinned
        buffers on the side stream, with an event after the copies (a
        tensor already on the card is taken as it is)."""
        if self._h2d_stream is None:
            return [t.to(self.device) for t in tensors], None
        out = []
        with torch.cuda.stream(self._h2d_stream):
            for t in tensors:
                if t.device.type == "cuda":
                    out.append(t)
                    continue
                pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                pinned.copy_(t)
                out.append(pinned.to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self._h2d_stream)
        return out, event

    @staticmethod
    def _pull_round(pull_reqs):
        """One overlapped pull round across tables. Requests sharing a
        client go through its `pull_sparse_multi` (concurrent lane
        connections — one RPC round of latency instead of one per table);
        results return in request order."""
        _fault_site("heter.pull")
        by_client: Dict[int, list] = {}
        for pos, (client, tid, keys) in enumerate(pull_reqs):
            by_client.setdefault(id(client), (client, []))[1].append(
                (pos, tid, keys))
        out = [None] * len(pull_reqs)
        for client, items in by_client.values():
            multi = getattr(client, "pull_sparse_multi", None)
            if multi is not None and len(items) > 1:
                got = multi([(tid, keys) for _, tid, keys in items])
            else:
                got = [client.pull_sparse(tid, keys)
                       for _, tid, keys in items]
            for (pos, _, _), rows in zip(items, got):
                out[pos] = rows
        return out

    # -- push stage ---------------------------------------------------------
    def _push(self, grows, push_meta):
        """Push for non-cached tables: waits for the producing step's copy
        to the host (``grows``, a `_HostRows`), then one RPC per table."""
        _fault_site("heter.push")
        t0 = time.perf_counter()
        for g, (emb, uniq) in zip(grows.wait(), push_meta):
            emb.client.push_sparse(emb._table_cfg.table_id, uniq,
                                   g[:uniq.size])
        dt = time.perf_counter() - t0
        if _metrics_mod.enabled():
            _H_PUSH.observe(dt)
        with self._totals_lock:
            self.stage_totals["push_s"] += dt

    def _push_retrying(self, grows, push_meta):
        # stage-level retry on top of the per-RPC retry inside PSClient: it
        # re-runs the WHOLE multi-table push, so it is at-least-once across
        # tables. That only matters after the client's own retry exhausted
        # (server genuinely down); injected faults at the `heter.push` site
        # fire before any RPC and retry cleanly.
        self._stage_retry.call(self._push, grows, push_meta,
                               op="heter.push")

    def _submit_push(self, fn, *args):
        import concurrent.futures
        if self._push_pool is None:
            self._push_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1)
        self._push_futs.append(self._push_pool.submit(fn, *args))

    def _drain_fut(self):
        if self._push_futs:
            futs, self._push_futs = self._push_futs, []
            for f in futs:
                f.result()  # propagate background push errors

    # -- pipelined prefetch -------------------------------------------------
    def prefetch(self, *batch):
        """Pipelined mode: hand the NEXT batch to the prepare stage so its
        route/unique/pull/H2D run while the card executes the current step.
        The following ``__call__`` MUST receive this same batch (enforced
        by object identity on the batch elements); an unconsumed prefetch
        is discarded side-effect-free by flush().

        Staleness stays bounded at 1 step: the prepare is CHAINED behind
        every push future already in flight (pushes through step t-1 plus
        eviction write-backs — the wait runs on the prefetch thread, so
        this call never blocks), and the pending step-t push is submitted
        here so at most that ONE push can race the prefetched pull."""
        assert self.mode == "pipelined", "prefetch() requires pipelined mode"
        assert self._prefetched is None, (
            "one prefetch may be outstanding; call the step first")
        arrs = self._as_tensors(batch)
        waits = list(self._push_futs)
        if self._pending is not None:
            prev, self._pending = self._pending, None
            self._submit_push(self._push_retrying, *prev)
        self._prefetched = (batch, self._submit_prepare(arrs, waits=waits))

    def _submit_prepare(self, arrs, waits=()):
        import concurrent.futures
        if self._prefetch_pool is None:
            self._prefetch_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1)
        if not waits:
            return self._prefetch_pool.submit(self._prepare, arrs)

        def chained():
            for f in waits:  # push errors surface at bundle.result()
                f.result()
            return self._prepare(arrs)

        return self._prefetch_pool.submit(chained)

    def _take_prefetched(self, batch, arrs):
        """Match a queued prefetch to this call, or submit one now."""
        if self._prefetched is not None:
            pre_batch, fut = self._prefetched
            self._prefetched = None
            # identity on the ORIGINAL batch objects: the converted
            # tensors of a numpy input are fresh objects every call
            if len(pre_batch) == len(batch) and all(
                    a is b for a, b in zip(pre_batch, batch)):
                return fut
            fut.result()  # surface errors; bundle itself is side-effect-free
            raise RuntimeError(
                "prefetch()/step batch mismatch: the batch handed to "
                "prefetch() must be the next one passed to the step "
                "(prefetched objects were not the ones just received)")
        return self._submit_prepare(arrs)

    # -- lifecycle ----------------------------------------------------------
    def _flush_pushes(self):
        """Drain the push worker + land the pending step's push (keeps the
        cache accumulators resident — see flush())."""
        if self._prefetched is not None:
            _, fut = self._prefetched
            self._prefetched = None
            try:  # abandoned bundles are side-effect-free by contract
                fut.result()
            except Exception:
                pass
        self._drain_fut()
        if self._pending is not None:
            grows, meta = self._pending
            self._pending = None
            if meta:
                self._push_retrying(grows, meta)

    def flush(self):
        """Land every outstanding push: drain the push worker, push the
        pending step's gradients, and write back all cache-resident
        gradient accumulators (no-op where nothing is outstanding)."""
        self._flush_pushes()
        if self._caches:
            from .cache import flush_all
            flush_all(self._caches.values())

    def close(self):
        """Teardown: land outstanding pushes, then join the worker threads.
        Call it before stopping the PS: an in-flight background push would
        race the server's shutdown. A flush failure is only swallowed when
        close() runs during exception unwinding (a clean close must not
        silently drop the last step's gradients)."""
        unwinding = sys.exc_info()[0] is not None
        try:
            self.flush()
        except Exception:
            self._pending = None  # teardown must not mask the original error
            if not unwinding:
                self._shutdown_pools()
                raise
        self._shutdown_pools()

    def _shutdown_pools(self):
        for attr in ("_push_pool", "_prefetch_pool"):
            pool = getattr(self, attr)
            if pool is not None:
                pool.shutdown(wait=True)
                setattr(self, attr, None)

    def __del__(self):
        try:
            self._shutdown_pools()
        except Exception:
            pass

    # -- one training step --------------------------------------------------
    @staticmethod
    def _as_tensors(batch):
        return tuple(a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
                     for a in batch)

    def __call__(self, *batch):
        t_wall = time.perf_counter()
        self._t += 1
        arrs = self._as_tensors(batch)
        if self.mode == "sync":
            # a mode flip mid-run must not drop grads (cache accumulators
            # stay resident)
            self._flush_pushes()
            bundle = self._prepare(arrs)
        elif self.mode == "async":
            if self._pending is not None:
                # hand last step's push to the worker NOW: its gradient
                # fetch and push RPC run beside this step's route and pull
                self._drain_fut()  # at most ONE background push in flight
                prev, self._pending = self._pending, None
                self._submit_push(self._push_retrying, *prev)
            bundle = self._prepare(arrs)
        else:  # pipelined
            # drain BEFORE the new prepare can pull: pulls for step t then
            # observe every push through step t-2 and can miss at most the
            # one about to be submitted (staleness <= 1)
            self._drain_fut()
            fut = self._take_prefetched(batch, arrs)
            if self._pending is not None:
                prev, self._pending = self._pending, None
                self._submit_push(self._push_retrying, *prev)
            bundle = fut.result()

        t_dispatch = time.perf_counter()
        loss, grows_push, push_meta = self._dispatch(bundle)
        dispatch_s = time.perf_counter() - t_dispatch

        if self.mode == "sync":
            if push_meta:
                self._push_retrying(grows_push, push_meta)
        elif push_meta:
            # the card is now executing step t; its push is handed to the
            # worker at the start of call t+1, beside that call's route and
            # pull (staleness <= 1 step). Fully cached steps push nothing.
            self._pending = (grows_push, push_meta)
        dt = time.perf_counter() - t_wall
        if _metrics_mod.enabled():
            _H_STEP.observe(dt, mode=self.mode)
        with self._totals_lock:
            self.stage_totals["steps"] += 1
            self.stage_totals["dispatch_s"] += dispatch_s
        return loss

    def _step_fn(self, rows_in, invs, batch):
        """Forward, backward and the in-place dense update; returns (loss,
        row gradients). Reads and writes only tensors that outlive the
        call, so it can be captured."""
        rows = [r.detach().requires_grad_(True) for r in rows_in]
        names = self._names
        with torch.enable_grad():
            _FEED.queue = [{"rows": r, "inverse": iv}
                           for r, iv in zip(rows, invs)]
            try:
                out, _ = self.apply_fn(self.params, self.buffers,
                                       *batch[:-1])
            finally:
                _FEED.queue = None
            loss = self._loss_fn(out, batch[-1])
            grads = torch.autograd.grad(
                loss, [self.params[k] for k in names] + rows,
                allow_unused=True)
        gp = {k: torch.zeros_like(self.params[k]) if g is None else g
              for k, g in zip(names, grads)}
        grows = tuple(torch.zeros_like(r) if g is None else g
                      for r, g in zip(rows, grads[len(names):]))
        self.optimizer.apply_fn(self.params, gp, self.opt_state,
                                lr=self._lr, t=self._step_t, inplace=True)
        return loss.detach(), grows

    def _dispatch(self, bundle: _Bundle):
        """Stages 2+3 on the main thread: cache combine/commit, the dense
        step (a graph replay on a card), cache apply, and push
        composition."""
        if bundle.event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(bundle.event)
            for c in bundle.calls:  # made on the side stream, used here
                for t in (c.plan_dev or ()) + (c.evict_slots_dev,):
                    if t is not None:
                        t.record_stream(cur)
            for t in (*bundle.rows, *bundle.invs, *bundle.arrs):
                t.record_stream(cur)
        cached_ix = [i for i, c in enumerate(bundle.calls)
                     if c.cache is not None]
        for i in cached_ix:
            c = bundle.calls[i]
            # eviction write-back: gather the evicted slots' pending grads
            # BEFORE this step's apply reuses the slots
            if c.evict_keys is not None and c.evict_keys.size:
                wb = _to_host([c.cache.writeback_rows(c.evict_slots_dev)])
                c.cache.note_writeback(int(c.evict_keys.size))
                self._submit_push(self._writeback_push, c.emb, c.evict_keys,
                                  wb)
        rows_list = list(bundle.rows)
        if cached_ix:
            from .cache import combine_batch
            served = combine_batch(
                [bundle.calls[i].cache for i in cached_ix],
                [bundle.calls[i].plan_dev for i in cached_ix],
                [bundle.rows[i] for i in cached_ix])
            for i, rows in zip(cached_ix, served):
                rows_list[i] = rows
                c = bundle.calls[i]
                c.cache.stats["device_gather"] += len(c.cplan.hits)

        self._lr.fill_(self.optimizer.get_lr())
        self._step_t.fill_(self._t)
        if self._graphs is not None:
            loss, grows = self._replay(rows_list, bundle)
        else:
            loss, grows = self._step_fn(rows_list, bundle.invs, bundle.arrs)

        grows_push, push_meta = [], []
        for c, g in zip(bundle.calls, grows):
            if c.cache is None:
                grows_push.append(g[:c.uniq.size])
                push_meta.append((c.emb, c.uniq))
                continue
            c.cache.commit(c.cplan)
            if c.cplan.overflow:
                # rare: unique keys beyond capacity found no slot — their
                # grads must reach the PS now (apply drops them)
                pos = np.asarray(c.cplan.overflow, np.int64)
                grows_push.append(g.index_select(
                    0, torch.from_numpy(pos).to(g.device)))
                push_meta.append((c.emb, c.uniq[pos]))
        if cached_ix:
            from .cache import apply_batch
            apply_batch([bundle.calls[i].cache for i in cached_ix],
                        [bundle.calls[i].plan_dev for i in cached_ix],
                        [rows_list[i] for i in cached_ix],
                        [grows[i] for i in cached_ix])
        return loss, _to_host(grows_push), push_meta

    def _replay(self, rows_list, bundle):
        """Copy the step's inputs into its graph's static inputs (main
        thread, on the step's stream) and replay it (capturing it on the
        key's first use). Returns the loss (a fresh copy) and the graph's
        row gradients, which the next replay overwrites."""
        key = (_signature(bundle.arrs), tuple(r.shape[0] for r in rows_list))
        static = self._static.get(key)
        if static is None:
            static = self._static[key] = tuple(
                [torch.empty_like(t) for t in ts]
                for ts in (rows_list, bundle.invs, bundle.arrs))
        torch._foreach_copy_([s for ss in static for s in ss],
                             [*rows_list, *bundle.invs, *bundle.arrs])
        fresh = key not in self._graphs.graphs
        loss, grows = self._graphs.run(key, lambda: self._step_fn(*static))
        return (loss if fresh else loss.clone()), grows

    @staticmethod
    def _writeback_push(emb, keys, wb):
        """Push worker task: land an eviction write-back on the PS."""
        (g,) = wb.wait()
        emb.client.push_sparse(emb._table_cfg.table_id, keys, g)

    # -- state --------------------------------------------------------------
    @torch.no_grad()
    def sync_to_layer(self):
        """Land every outstanding push, then write the step's parameters
        and buffers back into the layer."""
        self.flush()
        named = dict(self.layer.named_parameters())
        for k, v in self.params.items():
            named[k].copy_(v)
        named_b = dict(self.layer.named_buffers())
        for k, v in self.buffers.items():
            if k in named_b:
                named_b[k].copy_(v)


__all__ = ["HeterPSTrainStep"]
