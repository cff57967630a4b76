"""Continuous-batching autoregressive serving over the paged KV cache
(counterpart of ``paddle_tpu/inference/serving.py``, its core).

* a **request queue** feeds a FIXED decode batch of ``max_batch`` slots;
  admission happens per iteration (a finished sequence's slot is refilled
  on the very next step);
* **prefill is shape-bucketed**: a prompt pads up to the smallest
  configured bucket that holds it (powers of two by default);
* **each decode iteration** gathers the active slots into ``W`` lanes
  (``W`` = the smallest power-of-two bucket covering the active count,
  from 1 up to ``max_batch``) and runs every layer, paged attention with
  the K/V append, the logits and the sampling draw over them; only the
  chosen tokens come back. ``decode_mode="fused"`` (the default) runs
  that step on a card as ONE CUDA graph per (lane bucket, greedy or
  sampling variant), captured at its first use over static input
  buffers: an iteration is one host-to-device copy of the lane arrays,
  one replay and one copy of the tokens back (the reference's one jitted
  executable per bucket). On the CPU the same step runs over the same
  buffers without a graph. ``"eager"`` dispatches every op from Python,
  the A/B baseline; both modes give the same tokens, bit for bit;
* **pages, not slabs**: each sequence owns block-table pages from a
  refcounted :class:`PageAllocator`. Requests sharing a prompt prefix map
  their block tables at the SAME physical pages (the prefix cache); a
  shared page is copied only on the first divergent write (copy-on-write
  fork). When the pool runs dry the youngest request is PREEMPTED (pages
  freed, request requeued with its generated prefix) instead of the
  engine deadlocking;
* **serving metrics and traces**: the queue depth, batch occupancy, TTFT
  and TPOT (by decode ``path``) and goodput families of the metrics
  registry, a ``serving_admission`` / ``serving_eviction`` event per
  lifecycle edge, a per-request lifecycle trace (``profiler/reqtrace.py``)
  and the sliding-window SLO tracker (``profiler/slo.py``).

The reference rebinds ``self.cache`` to the functional result of every
update; here the cache's tensors are written in place, so one live set of
pools, block tables and context lengths exists for the engine's life, and
a captured step reads and writes them at fixed addresses. The host's
writes between iterations (page growth, copy-on-write copies, a released
slot's reset, an admission's block-table row) go to the same stream
before the next replay.
"""
from __future__ import annotations

import itertools
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._platform import resolve_device
from ..fault import site as _fault_site
from ..jit.graphs import StepGraphs
from ..ops.kernels import paged_attention as _pa
from ..profiler import events as _events
from ..profiler import health as _health
from ..profiler import metrics as _metrics
from ..profiler import reqtrace as _reqtrace
from ..profiler import slo as _slo
from ..utils.envparse import env_int
from .sampling import SamplingParams, any_sampled, sample_logits

__all__ = ["Request", "PageAllocator", "SamplingParams", "ServingEngine",
           "current_engine", "live_engines"]

#: live engines, newest last (weak references)
_engine_refs: List["weakref.ref[ServingEngine]"] = []
_engine_lock = threading.Lock()


def current_engine(name: Optional[str] = None) -> Optional["ServingEngine"]:
    """Most recently constructed live engine (or the newest of that model
    name)."""
    with _engine_lock:
        for ref in reversed(_engine_refs):
            eng = ref()
            if eng is None or eng._closed:
                continue
            if name is None or eng.name == name:
                return eng
    return None


def live_engines() -> List["ServingEngine"]:
    """Every live (non-closed) engine, oldest first."""
    out: List["ServingEngine"] = []
    with _engine_lock:
        for ref in _engine_refs:
            eng = ref()
            if eng is not None and not eng._closed:
                out.append(eng)
    return out


_REG = _metrics.default_registry()
_M_QUEUE = _REG.gauge(
    "serving_queue_depth",
    "requests queued waiting for a decode slot, by model")
_M_OCC = _REG.gauge(
    "serving_batch_occupancy",
    "active sequences in the fixed continuous-batching decode batch, "
    "by model")
_M_TTFT = _REG.histogram(
    "serving_ttft_seconds",
    "time to first token: request submit -> first generated token, "
    "by model and decode path (fused|eager)")
_M_TPOT = _REG.histogram(
    "serving_tpot_seconds",
    "time per output token after the first, observed once per finished "
    "request, by model and decode path (fused|eager)")
_M_GOODPUT = _REG.counter(
    "serving_goodput_tokens_total",
    "generated tokens delivered to finished or running requests, by model")


class PageAllocator:
    """Refcounted free-list allocator over the KV page pool. Page 0 is
    the NULL page (idle slots' block tables point at it; masked decode
    writes land there) and is never handed out.

    ``alloc`` hands out pages at refcount 1; ``fork`` increments the
    refcount of pages a second request maps at the same physical location
    (shared-prefix admission); ``free`` decrements, and a page returns to
    the free list only when its LAST holder releases it. ``on_release(page)``
    fires exactly once per page, at that last release."""

    def __init__(self, num_pages: int, on_release=None):
        self.num_pages = int(num_pages)
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        self._on_release = on_release

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def shared_page_count(self) -> int:
        """Pages currently held by more than one request (CoW-shared)."""
        return sum(1 for c in self._refs.values() if c > 1)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n page ids at refcount 1, or None when the pool can't cover the
        request (a partial grab is never left dangling)."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def fork(self, pages: Sequence[int]):
        """Share already-allocated pages with one more holder."""
        for p in pages:
            if p:
                self._refs[p] = self._refs.get(p, 0) + 1

    def refcount(self, page: int) -> int:
        return self._refs.get(int(page), 0)

    def is_shared(self, page: int) -> bool:
        return self.refcount(page) > 1

    def outstanding(self) -> Dict[int, int]:
        """{page: refcount} for every live page — the no-leak audit
        surface (empty once every request has finished)."""
        return dict(self._refs)

    def free(self, pages: Sequence[int]):
        """Release one holder's reference on each page; a page recycles
        to the free list only at refcount zero."""
        for p in pages:
            if not p:  # the null page is not pool-managed
                continue
            p = int(p)
            refs = self._refs.get(p, 1) - 1
            if refs > 0:
                self._refs[p] = refs
                continue
            self._refs.pop(p, None)
            self._free.append(p)
            if self._on_release is not None:
                self._on_release(p)


class _PrefixCache:
    """Token-chain -> physical-page registry for shared-prefix admission.

    Every page-aligned prefix of an admitted request's tokens maps to the
    page holding its last ``page_size`` tokens, and the exact full token
    list additionally maps to the partial tail page (if any). Lookup walks
    the longest chain of full pages matching a new prompt's prefix; the
    partial tail joins ONLY on an exact whole-prompt match.

    Entries hold no refcounts: the allocator's release hook (`drop_page`)
    evicts a page's entries when its last holder frees it, so the registry
    never hands out a recycled page."""

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self._full: Dict[Tuple[int, ...], int] = {}
        self._partial: Dict[Tuple[int, ...], int] = {}
        self._by_page: Dict[int, List[Tuple[str, Tuple[int, ...]]]] = {}

    def __len__(self):
        return len(self._full) + len(self._partial)

    def _put(self, kind: str, key: Tuple[int, ...], page: int):
        d = self._full if kind == "full" else self._partial
        if key in d:
            return
        d[key] = page
        self._by_page.setdefault(page, []).append((kind, key))

    def register(self, tokens: Sequence[int], pages: Sequence[int]):
        ps = self.page_size
        tokens = tuple(int(t) for t in tokens)
        for i in range(len(tokens) // ps):
            self._put("full", tokens[:(i + 1) * ps], pages[i])
        if len(tokens) % ps:
            self._put("partial", tokens, pages[len(tokens) // ps])

    def lookup(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """(shared_pages, shared_len): the longest registered chain
        covering a prefix of `tokens`."""
        ps = self.page_size
        tokens = tuple(int(t) for t in tokens)
        pages: List[int] = []
        n = 0
        for i in range(len(tokens) // ps):
            page = self._full.get(tokens[:(i + 1) * ps])
            if page is None:
                break
            pages.append(page)
            n = (i + 1) * ps
        tail = len(tokens) % ps
        if tail and n == len(tokens) - tail:
            page = self._partial.get(tokens)
            if page is not None:
                pages.append(page)
                n = len(tokens)
        return pages, n

    def drop_page(self, page: int):
        for kind, key in self._by_page.pop(int(page), []):
            d = self._full if kind == "full" else self._partial
            if d.get(key) == page:
                del d[key]


class Request:
    """One generation request. Thread-safe result hand-off: `result()`
    blocks until the engine completes (or fails) the request."""

    _ids = itertools.count(1)

    def __init__(self, prompt: Sequence[int], max_new_tokens: int,
                 eos_id: int = -1,
                 sampling: Optional[SamplingParams] = None):
        self.rid = next(Request._ids)
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = int(eos_id)
        self.sampling = sampling or SamplingParams()
        # per-request RNG stream, pure in (seed, n): preemption + recompute
        # resumes the identical stream
        self.seed = (self.sampling.seed if self.sampling.seed is not None
                     else self.rid) & 0x7FFFFFFF
        self.generated: List[int] = []
        self.state = "queued"          # queued|running|done|failed
        self.finish_reason: Optional[str] = None
        self.error: Optional[str] = None
        self.submitted_ts = time.monotonic()
        self.admitted_ts: Optional[float] = None   # first admission only
        self.first_token_ts: Optional[float] = None
        self.done_ts: Optional[float] = None
        self.trace_id: Optional[int] = None        # reqtrace id (if on)
        self.preemptions = 0
        self.slot: Optional[int] = None
        self.pages: List[int] = []
        self.shared_tokens = 0         # prefix tokens served from shared pages
        self._done = threading.Event()

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_ts is None:
            return None
        return self.first_token_ts - self.submitted_ts

    @property
    def tpot_s(self) -> Optional[float]:
        """Per-output-token latency AFTER the first token; None until done
        or with <2 tokens."""
        if self.done_ts is None or self.first_token_ts is None \
                or len(self.generated) < 2:
            return None
        return (self.done_ts - self.first_token_ts) \
            / (len(self.generated) - 1)

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Generated token ids (eos included when hit). Raises on engine
        failure or timeout."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} not done")
        if self.state == "failed":
            raise RuntimeError(f"request {self.rid} failed: {self.error}")
        return list(self.generated)


def _pow2_buckets(lo: int, hi: int) -> List[int]:
    out, b = [], max(int(lo), 1)
    while b < hi:
        out.append(b)
        b <<= 1
    out.append(hi)
    return out


class _LaneBuffers:
    """The fused step's static inputs and output for one lane bucket W.

    The inputs live in one pinned host staging buffer and its device
    twin, both laid out as [5, W] int64 (tokens, slot_map, top_k, seeds,
    steps), [2, W] float32 (temperature, top_p) and [W] bool
    (lane_active), so an iteration moves them in one copy; the step
    writes its [W] int32 tokens into ``out``, which comes back into the
    pinned ``out_host``."""

    def __init__(self, W: int, device: torch.device):
        pin = device.type == "cuda"
        self.host = torch.zeros(49 * W, dtype=torch.uint8, pin_memory=pin)
        self.dev = torch.zeros(49 * W, dtype=torch.uint8, device=device)
        h = self.host.numpy()
        self.host_ints = h[:40 * W].view(np.int64).reshape(5, W)
        self.host_floats = h[40 * W:48 * W].view(np.float32).reshape(2, W)
        self.host_active = h[48 * W:].view(np.bool_)
        ints = self.dev[:40 * W].view(torch.int64).view(5, W)
        floats = self.dev[40 * W:48 * W].view(torch.float32).view(2, W)
        (self.tokens, self.slot_map, self.top_k, self.seeds,
         self.steps) = ints.unbind(0)
        self.temp, self.top_p = floats.unbind(0)
        self.active = self.dev[48 * W:].view(torch.bool)
        self.out = torch.zeros(W, dtype=torch.int32, device=device)
        self.out_host = torch.zeros(W, dtype=torch.int32, pin_memory=pin)


class ServingEngine:
    """Continuous-batching decode engine over one model's paged KV cache.

    `model` must expose the GPT decode protocol (`init_cache`,
    `forward_prefill`, `forward_decode` — models/gpt.py) and live on
    `device` (``cuda`` unless the caller passes ``"cpu"``). Drive it
    either synchronously (`submit` then `run_until_idle`) or with the
    background thread (`start()`; `close()` joins it). The options are
    keyword-only, as in the reference.

    `num_pages` below full backing turns the allocator into a real
    constraint: admission waits for pages and decode preempts when the
    pool runs dry. `mem_budget_bytes` caps the pool's bytes at
    construction (`pool_bytes()`). `eos_id` is the engine-wide stop token
    a request takes unless it names its own.

    `decode_mode`: "fused" (default) runs each decode iteration as one
    step over static buffers, on a card one CUDA graph per (lane bucket,
    greedy or sampling variant), captured at its first use; a failed
    capture or replay raises. The step runs with the per-op NaN check
    suspended (the reference's check does not look inside its jitted
    executable either). "eager" dispatches the same math op by op. Both
    modes give the same tokens, bit for bit.

    `share_prefix` (default True) admits a request whose prompt prefix is
    already resident by FORKING its pages copy-on-write instead of
    recomputing and re-storing the K/V. `priority` is recorded (the
    reference's degradation order). `mesh` (tensor-parallel decode) is
    not ported; `tp_axis`, which only names a mesh axis, is taken and
    unused."""

    def __init__(self, model, *, max_batch: int = 4, max_len: int = 256,
                 page_size: int = 16, num_pages: int = 0,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 eos_id: int = -1, name: str = "gpt",
                 decode_mode: str = "fused", share_prefix: bool = True,
                 priority: int = 0, mem_budget_bytes: int = 0,
                 mesh=None, tp_axis: str = "tp", device=None):
        if decode_mode not in ("fused", "eager"):
            raise ValueError(f"decode_mode must be 'fused' or 'eager', "
                             f"got {decode_mode!r}")
        if mesh is not None:
            raise NotImplementedError(
                "ServingEngine(mesh=): tensor-parallel decode is not ported "
                "(ROADMAP A11)")
        self.device = resolve_device(device)
        model_dev = next(model.parameters()).device
        if model_dev.type != self.device.type or (
                self.device.index is not None
                and model_dev.index != self.device.index):
            raise ValueError(f"ServingEngine on {self.device} was given a "
                             f"model on {model_dev}")
        model.eval()
        self.model = model
        self.name = name
        self.max_batch = int(max_batch)
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.eos_id = int(eos_id)
        self.decode_mode = decode_mode
        self.share_prefix = bool(share_prefix)
        self.priority = int(priority)
        self.mem_budget_bytes = int(mem_budget_bytes)
        self.cache = model.init_cache(max_batch, max_len,
                                      page_size=page_size,
                                      num_pages=num_pages)
        self._budget_capped: Optional[Tuple[int, int]] = None
        if self.mem_budget_bytes > 0:
            per_page = max(1, self.pool_bytes() // self.cache.num_pages)
            fit = int(self.mem_budget_bytes // per_page)
            if fit < self.cache.num_pages:
                capped = max(2, fit)
                self._budget_capped = (self.cache.num_pages, capped)
                self.cache = None  # free the full pool before the capped one
                self.cache = model.init_cache(max_batch, max_len,
                                              page_size=page_size,
                                              num_pages=capped)
        self._prefix = _PrefixCache(page_size)
        self.allocator = PageAllocator(self.cache.num_pages,
                                       on_release=self._prefix.drop_page)
        if prefill_buckets is None:
            prefill_buckets = _pow2_buckets(min(16, self.max_len),
                                            self.max_len)
        self.prefill_buckets = sorted(set(int(b) for b in prefill_buckets))
        if self.prefill_buckets[-1] < self.max_len:
            self.prefill_buckets.append(self.max_len)
        # one lane bucket per power of two from 1 to max_batch (the
        # reference's static default: lane-bucketed, min_lanes=1)
        self.decode_buckets = _pow2_buckets(1, self.max_batch)
        self._queue: "deque[Request]" = deque()
        self._lock = threading.Lock()
        self._slots: List[Optional[Request]] = [None] * self.max_batch
        self._cur_tokens = np.zeros((self.max_batch,), np.int32)
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        # the fused step: static buffers per lane bucket; on a card one
        # graph per (W, variant) with the launch counts of its capture,
        # all in one memory pool, and the side stream of the first runs
        self._lanes: Dict[int, _LaneBuffers] = {}
        self._step_graphs = StepGraphs(self.device, f"ServingEngine {name}")
        self.stats = {"iterations": 0, "prefills": 0, "decode_tokens": 0,
                      "completed": 0, "preemptions": 0, "decode_wall_s": 0.0,
                      "prefill_wall_s": 0.0, "cow_copies": 0,
                      "prefix_hit_tokens": 0, "shared_admissions": 0,
                      "graph_captures": 0,
                      "min_free_pages": self.allocator.free_pages}
        # request-scoped observability: lifecycle tracer, sliding-window
        # SLO tracker and a bounded ring of per-iteration snapshots
        self.tracer = _reqtrace.RequestTracer(name)
        self.slo = _slo.SLOTracker(name)
        self._introspect: "deque[dict]" = deque(
            maxlen=max(1, env_int("PADDLE_TPU_SERVING_INTROSPECT_RING",
                                  256)))
        self._last_progress = time.monotonic()
        with _engine_lock:
            _engine_refs.append(weakref.ref(self))
            del _engine_refs[:-8]  # bound the registry

    # -- public API -----------------------------------------------------------
    def make_request(self, prompt: Sequence[int], max_new_tokens: int = 16,
                     eos_id: Optional[int] = None,
                     sampling: Optional[SamplingParams] = None) -> Request:
        """Validate and build a Request WITHOUT enqueueing it. `eos_id`
        None takes the engine's."""
        if self._closed:
            raise RuntimeError("engine is closed")
        # chaos: an armed `serving.admit` fails admission before the
        # request exists (the reference's shed drill)
        _fault_site("serving.admit")
        req = Request(prompt, max_new_tokens,
                      self.eos_id if eos_id is None else eos_id,
                      sampling=sampling)
        if not req.prompt:
            raise ValueError("empty prompt")
        vocab = self.model.cfg.vocab_size
        if min(req.prompt) < 0 or max(req.prompt) >= vocab:
            # the reference's embedding gather clamps or fills silently;
            # on the card an out-of-range id is a device-side fault
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {len(req.prompt)} + max_new_tokens "
                f"{req.max_new_tokens} exceeds max_len {self.max_len}")
        total_pages = -(-(len(req.prompt) + req.max_new_tokens)
                        // self.page_size)
        if total_pages > self.cache.num_pages - 1:
            # a request the pool can NEVER satisfy would wedge the queue
            raise ValueError(
                f"request needs {total_pages} KV pages but the pool holds "
                f"{self.cache.num_pages - 1} (num_pages minus the null "
                f"page); raise num_pages or lower max_new_tokens")
        return req

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               sampling: Optional[SamplingParams] = None) -> Request:
        req = self.make_request(prompt, max_new_tokens, eos_id,
                                sampling=sampling)
        with self._lock:
            # re-check under the lock: a close() racing this submit has
            # already drained the queue
            if self._closed:
                raise RuntimeError("engine is closed")
            self._queue.append(req)
            depth = len(self._queue)
        req.trace_id = self.tracer.submit(req.rid)
        if _metrics.enabled():
            _M_QUEUE.set(depth, model=self.name)
        return req

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def pending(self) -> bool:
        with self._lock:
            return bool(self._queue) or any(
                r is not None for r in self._slots)

    def step(self) -> int:
        """ONE continuous-batching iteration: admit waiting requests into
        free slots (bucketed prefill each, shared-prefix pages forked),
        grow pages for sequences crossing a page boundary and fork any
        shared page about to be written, preempting the youngest on pool
        exhaustion, then one decode pass. Returns the number of tokens
        generated by the decode pass (0 = engine idle)."""
        self._admit()
        active_slots = [i for i, r in enumerate(self._slots)
                        if r is not None]
        if _metrics.enabled():
            _M_OCC.set(len(active_slots), model=self.name)
        if not active_slots:
            return 0
        self._ensure_capacity(active_slots)
        active_slots = [i for i, r in enumerate(self._slots)
                        if r is not None]  # capacity may have preempted
        if not active_slots:
            return 0
        produced = self._decode_iteration(active_slots)
        self._note_introspection(len(active_slots))
        self._last_progress = time.monotonic()
        return produced

    def _note_introspection(self, active: int):
        """One bounded-ring snapshot per decode iteration."""
        with self._lock:
            depth = len(self._queue)
        used = self.cache.num_pages - 1 - self.allocator.free_pages
        self._introspect.append({
            "iteration": self.stats["iterations"],
            "ts": time.time(),
            "active": active,
            "lanes": self._decode_bucket(active),
            "occupancy": sum(r is not None for r in self._slots),
            "queue_depth": depth,
            "free_pages": self.allocator.free_pages,
            "used_pages": used,
            "cow_shared_pages": self.allocator.shared_page_count,
            "decode_mode": self.decode_mode,
        })

    def introspection(self, n: int = 32) -> List[dict]:
        return list(self._introspect)[-max(0, n):]

    def run_until_idle(self, max_iterations: int = 100000):
        for _ in range(max_iterations):
            if not self.pending():
                return
            self.step()
        raise RuntimeError("run_until_idle: iteration cap exceeded")

    def start(self, poll_s: float = 0.005):
        """Background decode loop: steps while work exists, naps when idle.
        close() joins it. An exception out of step() is fatal for the
        engine: it fails every outstanding request instead of leaving a
        silently dead thread that strands clients in result()."""
        if self._thread is not None:
            return

        def loop():
            while not self._closed:
                try:
                    if not self.pending() or self.step() == 0:
                        time.sleep(poll_s)
                except Exception as e:  # noqa: BLE001 — see docstring
                    import warnings
                    err = f"{type(e).__name__}: {e}"
                    warnings.warn(f"serving engine {self.name!r} decode loop "
                                  f"died ({err}); failing outstanding "
                                  f"requests")
                    self._closed = True
                    self._fail_outstanding(f"engine decode loop died: {err}")
                    return

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"serving-{self.name}")
        self._thread.start()

    def close(self):
        """Stop the engine. Outstanding requests FAIL with a clean 'engine
        closed' error — a client blocked in result() never hangs."""
        self._closed = True
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self._fail_outstanding("engine closed")

    def _fail_outstanding(self, error: str):
        with self._lock:
            leftovers = list(self._queue) + [r for r in self._slots
                                             if r is not None]
            self._queue.clear()
        for req in leftovers:
            self._complete(req, "failed", error=error)

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 16,
                 sampling: Optional[SamplingParams] = None,
                 timeout: float = 120.0) -> Dict:
        """Synchronous one-call inference: submit, drive the loop inline
        when no background thread runs, wait, and return the result."""
        req = self.submit(prompt, max_new_tokens=max_new_tokens,
                          sampling=sampling)
        if self._thread is None:
            self.run_until_idle()
        tokens = req.result(timeout=timeout)
        return {
            "request": req.rid,
            "trace_id": req.trace_id,
            "model": self.name,
            "tokens": tokens,
            "finish_reason": req.finish_reason,
            "preemptions": req.preemptions,
            "ttft_s": req.ttft_s,
            "tpot_s": req.tpot_s,
            "e2e_s": (req.done_ts - req.submitted_ts
                      if req.done_ts is not None else None),
        }

    def pool_bytes(self) -> int:
        """Device bytes held by the KV page pools (all layers, K + V)."""
        return int(sum(k.nbytes + v.nbytes for k, v in
                       zip(self.cache.k_pages, self.cache.v_pages)))

    def requests_snapshot(self, n: int = 50) -> Dict:
        """Live and recently completed per-request phase breakdowns plus
        the per-iteration introspection ring."""
        snap = self.tracer.snapshot(n)
        with self._lock:
            snap["queue_depth"] = len(self._queue)
        snap["occupancy"] = sum(r is not None for r in self._slots)
        snap["introspection"] = self.introspection(n)
        return snap

    def status(self) -> Dict:
        """The reference's status keys (those of its unported control
        plane at their idle values: no tensor-parallel mesh, no reserved
        pages, no queue cap, no suspension, no weight swap), plus the
        device and the number of captured step graphs."""
        with self._lock:
            return {
                "model": self.name,
                "max_batch": self.max_batch,
                "max_len": self.max_len,
                "page_size": self.page_size,
                "num_pages": self.cache.num_pages,
                "free_pages": self.allocator.free_pages,
                "queue_depth": len(self._queue),
                "occupancy": sum(r is not None for r in self._slots),
                "prefill_buckets": list(self.prefill_buckets),
                "decode_buckets": list(self.decode_buckets),
                "decode_mode": self.decode_mode,
                "tp_degree": 1,
                "tp_axis": None,
                "share_prefix": self.share_prefix,
                "prefix_entries": len(self._prefix),
                "priority": self.priority,
                "mem_budget_bytes": self.mem_budget_bytes,
                "budget_capped_pages": self._budget_capped,
                "reserved_pages": 0,
                "queue_limit": None,
                "suspended": None,
                "weights_step": None,
                "last_swap": None,
                "stats": dict(self.stats),
                "device": str(self.device),
                "graphs": len(self._graphs),
            }

    @property
    def _graphs(self) -> dict:
        """{(lane bucket, variant): (graph, launch counts, outputs)}."""
        return self._step_graphs.graphs

    @property
    def graph_replays(self) -> Dict[Tuple[int, str], int]:
        return self._step_graphs.replays

    @property
    def graph_pool_bytes(self) -> int:
        return self._step_graphs.pool_bytes

    # -- internals ------------------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if b >= n:
                return b
        return self.prefill_buckets[-1]

    def _decode_bucket(self, n: int) -> int:
        for b in self.decode_buckets:
            if b >= n:
                return b
        return self.decode_buckets[-1]

    def _note_pool_watermark(self):
        if self.allocator.free_pages < self.stats["min_free_pages"]:
            self.stats["min_free_pages"] = self.allocator.free_pages

    def _admit(self):
        """Per-iteration admission: fill every free slot whose prompt the
        page pool can cover right now. A prompt whose prefix is already
        resident FORKS the matching pages instead of allocating and
        recomputing them; prefill then skips the K/V write below the
        shared length."""
        while True:
            with self._lock:
                if not self._queue:
                    break
                free = [i for i, r in enumerate(self._slots) if r is None]
                if not free:
                    break
                req = self._queue[0]
                # admission prompt = original prompt + any tokens already
                # generated before a preemption (recompute-style resume)
                tokens = req.prompt + req.generated
                n_pages = -(-len(tokens) // self.page_size)
                shared_pages: List[int] = []
                shared_len = 0
                if self.share_prefix:
                    shared_pages, shared_len = self._prefix.lookup(tokens)
                new_pages = self.allocator.alloc(n_pages - len(shared_pages))
                if new_pages is None:
                    break  # pool exhausted: wait for frees
                self.allocator.fork(shared_pages)
                pages = shared_pages + new_pages
                self._queue.popleft()
                slot = free[0]
                req.slot, req.pages, req.state = slot, pages, "running"
                req.shared_tokens = shared_len
                self._slots[slot] = req
                depth = len(self._queue)
            if shared_len:
                self.stats["shared_admissions"] += 1
                self.stats["prefix_hit_tokens"] += shared_len
            self._note_pool_watermark()
            bucket = self._bucket_for(len(tokens))
            if req.admitted_ts is None:
                req.admitted_ts = time.monotonic()
                self.slo.observe("queue_wait",
                                 req.admitted_ts - req.submitted_ts)
            self.tracer.admitted(req.rid, bucket=bucket,
                                 prompt_tokens=len(tokens),
                                 shared_tokens=shared_len,
                                 requeue=req.preemptions > 0)
            row = np.zeros((self.cache.pages_per_seq,), np.int32)
            row[:len(pages)] = pages
            self.cache.block_tables[slot] = torch.from_numpy(row).to(
                self.device)
            ids = np.zeros((1, bucket), np.int64)
            ids[0, :len(tokens)] = tokens
            sp = req.sampling
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, _ = self.model.forward_prefill(
                    torch.from_numpy(ids).to(self.device), self.cache, slot,
                    len(tokens), write_start=shared_len)
                # the FIRST generated token is sampled like every other
                # (step counter 0, or len(generated) after a preemption)
                nxt = sample_logits(logits, [sp.temperature], [sp.top_k],
                                    [sp.top_p], [req.seed],
                                    [len(req.generated)])
            tok = int(nxt[0])  # device sync: the prefill boundary
            self.stats["prefill_wall_s"] += time.perf_counter() - t0
            self.stats["prefills"] += 1
            if self.share_prefix:
                self._prefix.register(tokens, pages)
            self.tracer.prefill_done(req.rid)
            if req.first_token_ts is None:
                req.first_token_ts = time.monotonic()
                if _metrics.enabled():
                    _M_TTFT.observe(req.ttft_s, model=self.name,
                                    path=self.decode_mode)
                self.slo.observe("ttft", req.ttft_s)
            self._emit_admission(req, bucket, len(tokens))
            self._record_token(req, tok)
            if _metrics.enabled():
                _M_QUEUE.set(depth, model=self.name)
            if req.state != "running":
                continue  # single-token request finished at prefill
            self._cur_tokens[slot] = tok

    def _alloc_one_or_preempt(self, req: Request) -> Optional[int]:
        """One fresh page for `req`, preempting the youngest runner on a
        dry pool. None => `req` itself was preempted or failed (caller
        must stop touching it)."""
        while True:
            got = self.allocator.alloc(1)
            if got is not None:
                self._note_pool_watermark()
                return got[0]
            victim = self._youngest_running()
            running = sum(r is not None for r in self._slots)
            if victim is None or (victim is req and running == 1):
                # sole runner with a dry pool: submit-time validation
                # bounds TOTAL need, so this is an external consumer of
                # the pool — fail loudly rather than preempt-requeue-wedge
                self._complete(req, "failed",
                               error="KV page pool exhausted")
                return None
            self._preempt(victim)
            if victim is req:
                return None

    def _ensure_capacity(self, active_slots: List[int]):
        """Every active sequence about to write position `ctx` needs (a)
        the page ctx // page_size allocated — grow by one where the
        boundary was crossed — and (b) EXCLUSIVE ownership of the page it
        writes into: a shared (refcount > 1) write page is forked
        copy-on-write — the page is copied across every layer's pools, the
        block table repoints, and the other sharers keep the original.
        Preempts the youngest request when the pool is dry."""
        bt = self.cache.block_tables
        for slot in list(active_slots):
            req = self._slots[slot]
            if req is None:
                continue
            ctx = len(req.prompt) + len(req.generated)
            need = ctx // self.page_size + 1
            dead = False
            while len(req.pages) < need:
                page = self._alloc_one_or_preempt(req)
                if page is None:
                    dead = True
                    break
                req.pages.append(page)
                bt[slot, len(req.pages) - 1] = page
            if dead or self._slots[slot] is not req:
                continue
            # copy-on-write: the page receiving this iteration's K/V write
            # (position ctx-1 = the token sampled last iteration)
            write_idx = (ctx - 1) // self.page_size
            if write_idx >= len(req.pages):
                continue
            old = req.pages[write_idx]
            if not self.allocator.is_shared(old):
                continue
            fresh = self._alloc_one_or_preempt(req)
            if fresh is None:
                continue
            _pa.cow_copy_pages(self.cache.k_pages, self.cache.v_pages, old,
                               fresh)
            bt[slot, write_idx] = fresh
            req.pages[write_idx] = fresh
            self.allocator.free([old])  # drop this holder's shared ref
            self.stats["cow_copies"] += 1

    def _youngest_running(self) -> Optional[Request]:
        running = [r for r in self._slots if r is not None]
        if not running:
            return None
        return max(running, key=lambda r: r.submitted_ts)

    def _lane_arrays(self, active_slots: List[int]):
        """Gather the active slots into W bucketed lanes (W = smallest
        decode bucket covering the active count). Padding lanes carry the
        slot sentinel `max_batch` and greedy sampling params."""
        n = len(active_slots)
        W = self._decode_bucket(n)
        slot_map = np.full((W,), self.max_batch, np.int64)
        tokens = np.zeros((W,), np.int64)
        lane_active = np.zeros((W,), bool)
        temp = np.zeros((W,), np.float32)
        top_k = np.zeros((W,), np.int64)
        top_p = np.ones((W,), np.float32)
        seeds = np.zeros((W,), np.int64)
        steps = np.zeros((W,), np.int64)
        for i, slot in enumerate(active_slots[:W]):
            req = self._slots[slot]
            sp = req.sampling
            slot_map[i] = slot
            tokens[i] = self._cur_tokens[slot]
            lane_active[i] = True
            temp[i] = sp.temperature
            top_k[i] = sp.top_k
            top_p[i] = sp.top_p
            seeds[i] = req.seed
            steps[i] = len(req.generated)
        return (W, tokens, slot_map, lane_active, temp, top_k, top_p,
                seeds, steps)

    def _decode_iteration(self, active_slots: List[int]) -> int:
        # chaos: an armed `serving.decode=N:delay` sleeps here, inflating
        # TTFT/TPOT as a slow device would (the SLO-breach drill)
        try:
            _fault_site("serving.decode")
        except Exception:
            pass  # only delay/no-op kinds make sense here; ignore others
        lanes = self._lane_arrays(active_slots)
        W, temp = lanes[0], lanes[4]
        # the reference's lax.cond over "every lane greedy", taken on the
        # host: temperatures are host data
        sampled = any_sampled(temp)
        t0 = time.perf_counter()
        if self.decode_mode == "fused":
            nxt_np = self._fused_iteration(lanes, sampled)
        else:
            nxt_np = self._eager_iteration(lanes, sampled)
        self.stats["decode_wall_s"] += time.perf_counter() - t0
        self.stats["iterations"] += 1
        produced = 0
        for i, slot in enumerate(active_slots[:W]):
            req = self._slots[slot]
            if req is None:
                continue
            tok = int(nxt_np[i])
            self.tracer.decode_iteration(req.rid, bucket=W,
                                         path=self.decode_mode)
            self._record_token(req, tok)
            produced += 1
            if req.state == "running":
                self._cur_tokens[slot] = tok
        self.stats["decode_tokens"] += produced
        if _metrics.enabled():
            # re-publish occupancy AFTER completions so a drained batch
            # reads 0 even when no further step() runs
            _M_OCC.set(sum(r is not None for r in self._slots),
                       model=self.name)
        return produced

    def _eager_iteration(self, lanes, sampled: bool) -> np.ndarray:
        """The step dispatched op by op from Python, its lane arrays
        copied to the device one by one."""
        (W, tokens, slot_map, lane_active, temp, top_k, top_p, seeds,
         steps) = lanes
        dev = self.device
        active = torch.from_numpy(lane_active).to(dev)
        with torch.no_grad():
            logits, _ = self.model.forward_decode(
                torch.from_numpy(tokens).to(dev), self.cache, active,
                slot_map=torch.from_numpy(slot_map).to(dev))
            nxt = sample_logits(logits, temp, top_k, top_p, seeds, steps,
                                sampled=sampled)
            nxt = torch.where(active, nxt, 0)
        return nxt.cpu().numpy()  # device sync: the iteration boundary

    def _step_fn(self, buf: _LaneBuffers, sampled: bool):
        """The fused step over `buf`'s static tensors (the counterpart of
        the reference's ``_fused_step_fn``): every layer with the K/V
        append and paged attention, the logits, the draw, and the padding
        lanes' tokens zeroed into ``buf.out``. It runs with the per-op NaN
        check suspended: the reference's check does not look inside its
        jitted step."""
        with torch.no_grad(), _health.suspended():
            logits, _ = self.model.forward_decode(
                buf.tokens, self.cache, buf.active, slot_map=buf.slot_map)
            nxt = sample_logits(logits, buf.temp, buf.top_k, buf.top_p,
                                buf.seeds, buf.steps, sampled=sampled)
            buf.out.copy_(torch.where(buf.active, nxt, 0))

    def _fused_iteration(self, lanes, sampled: bool) -> np.ndarray:
        """One host-to-device copy of the lane arrays into the bucket's
        static inputs, the step (a graph replay on a card), and one copy
        of the tokens back, which is the iteration boundary."""
        (W, tokens, slot_map, lane_active, temp, top_k, top_p, seeds,
         steps) = lanes
        buf = self._lanes.get(W)
        if buf is None:
            buf = self._lanes[W] = _LaneBuffers(W, self.device)
        buf.host_ints[:] = (tokens, slot_map, top_k, seeds, steps)
        buf.host_floats[:] = (temp, top_p)
        buf.host_active[:] = lane_active
        buf.dev.copy_(buf.host, non_blocking=True)
        if self.device.type != "cuda":
            self._step_fn(buf, sampled)
            return buf.out.numpy().copy()
        key = (W, "sampled" if sampled else "greedy")
        captures = self._step_graphs.captures
        self._step_graphs.run(key, lambda: self._step_fn(buf, sampled))
        self.stats["graph_captures"] += self._step_graphs.captures - captures
        buf.out_host.copy_(buf.out, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return buf.out_host.numpy().copy()

    def _record_token(self, req: Request, tok: int):
        req.generated.append(tok)
        if _metrics.enabled():
            # per-token goodput (prefill's first token included)
            _M_GOODPUT.inc(1.0, model=self.name)
        if req.eos_id >= 0 and tok == req.eos_id:
            self._complete(req, "eos")
        elif len(req.generated) >= req.max_new_tokens:
            self._complete(req, "length")

    def _complete(self, req: Request, reason: str,
                  error: Optional[str] = None):
        """Free the request's slot + pages; reason eos|length|failed."""
        self._release_slot(req)
        req.finish_reason = reason
        req.done_ts = time.monotonic()
        req.state = "failed" if reason == "failed" else "done"
        req.error = error
        if reason != "failed":
            self.stats["completed"] += 1
            if req.tpot_s is not None:
                if _metrics.enabled():
                    _M_TPOT.observe(req.tpot_s, model=self.name,
                                    path=self.decode_mode)
                self.slo.observe("tpot", req.tpot_s)
            self.slo.observe("e2e", req.done_ts - req.submitted_ts)
        self.tracer.complete(req.rid, reason, error=error)
        self._emit_eviction(req, reason)
        req._done.set()

    def _preempt(self, req: Request):
        """Recompute-style preemption: pages freed (shared pages only
        DECREF), request requeued at the head with its generated prefix as
        part of the next admission's prompt."""
        self._release_slot(req)
        self.tracer.preempted(req.rid)
        req.state = "queued"
        req.slot = None
        req.preemptions += 1
        self.stats["preemptions"] += 1
        with self._lock:
            self._queue.appendleft(req)
            depth = len(self._queue)
        if _metrics.enabled():
            _M_QUEUE.set(depth, model=self.name)
        self._emit_eviction(req, "preempted")

    def _release_slot(self, req: Request):
        slot = req.slot
        if slot is not None and self._slots[slot] is req:
            self._slots[slot] = None
            self._cur_tokens[slot] = 0
            # point the slot's block table back at the null page and zero
            # its context so the batched decode masks it out entirely
            self.cache.block_tables[slot] = 0
            self.cache.context_lens[slot] = 0
        self.allocator.free(req.pages)
        req.pages = []

    # -- events ---------------------------------------------------------------
    def _emit_admission(self, req: Request, bucket: int, prompt_len: int):
        _events.emit(
            "serving_admission", model=self.name, request=req.rid,
            slot=req.slot, prompt_len=prompt_len, bucket=bucket,
            queue_wait_s=round(time.monotonic() - req.submitted_ts, 4),
            preemptions=req.preemptions,
            shared_tokens=req.shared_tokens,
            free_pages=self.allocator.free_pages)

    def _emit_eviction(self, req: Request, reason: str):
        _events.emit(
            "serving_eviction",
            severity="warn" if reason in ("preempted", "failed") else "info",
            model=self.name, request=req.rid, reason=reason,
            generated=len(req.generated),
            free_pages=self.allocator.free_pages)
