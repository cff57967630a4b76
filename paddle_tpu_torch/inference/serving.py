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
* **prefill is captured too**: in ``decode_mode="fused"`` a request's
  prefill (the block-table row, every layer with its K/V written into the
  pages, the first token's draw) is one CUDA graph per (prompt bucket,
  greedy or sampling variant) in the same pool as the decode step's, over
  static input buffers: one host-to-device copy, one replay and the token
  back. ``"eager"`` prefills op by op;
* **the self-healing plane** (the reference's): a weight swap staged off
  the decode path and applied at an iteration boundary, its rollback and
  a canary score; a restart that requeues the in-flight requests; and
  the admission gates a :class:`~.governor.MemoryGovernor` drives
  (suspension, a queue cap, parked pages);
* **serving metrics and traces**: the queue depth, batch occupancy, TTFT
  and TPOT (by decode ``path``), goodput, swap, restart and suspension
  families of the metrics registry, a ``serving_admission`` /
  ``serving_eviction`` / ``serving_swap`` / ``serving_restart`` event per
  lifecycle edge, a per-request lifecycle trace (``profiler/reqtrace.py``)
  and the sliding-window SLO tracker (``profiler/slo.py``).

The reference rebinds ``self.cache`` to the functional result of every
update; here the cache's tensors are written in place, so one live set of
pools, block tables and context lengths exists for the engine's life, and
a captured step reads and writes them at fixed addresses. The host's
writes between iterations (page growth, copy-on-write copies, a released
slot's reset) go to the same stream before the next replay. For the same
reason the reference's two rebinds become in-place writes: a swap copies
the new weights into the live parameters' storage (the reference rebinds
its parameter dict), and a restart zeroes the pools, block tables and
context lengths (the reference builds a new cache), so every captured
graph stays valid and none is captured again.
"""
from __future__ import annotations

import itertools
import math
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
from ..profiler import compile_watch as _compile_watch
from ..profiler import events as _events
from ..profiler import health as _health
from ..profiler import metrics as _metrics
from ..profiler import reqtrace as _reqtrace
from ..profiler import slo as _slo
from ..profiler.watchdog import get_watchdog as _get_watchdog
from ..utils.envparse import env_float, env_int
from .sampling import SamplingParams, any_sampled, sample_logits

__all__ = ["EngineSuspended", "Request", "PageAllocator", "SamplingParams",
           "ServingEngine", "current_engine", "live_engines"]

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


class EngineSuspended(RuntimeError):
    """Admission refused: the engine is suspended (memory-pressure
    degradation). Carries ``retry_after_s`` so an endpoint can answer 503
    with a Retry-After header instead of a bare error."""

    def __init__(self, model: str, reason: str, retry_after_s: float):
        super().__init__(
            f"engine {model!r} suspended ({reason}); "
            f"retry after {retry_after_s:g}s")
        self.model = model
        self.reason = reason
        self.retry_after_s = float(retry_after_s)


def _no_fencing(term, policy: str):
    """The reference checks a controller's fencing token here
    (``distributed/fleet/leader.py:check_term``); the port has no leader,
    so only the operator's ``term=None`` passes."""
    if term is not None:
        raise NotImplementedError(
            f"{policy}: term={term!r} needs the fleet leader's fencing "
            f"(check_term), which is not ported (ROADMAP A12)")


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
_M_SWAP_TOTAL = _REG.counter(
    "serving_swap_total",
    "weight hot-swap attempts by model and outcome "
    "(applied|rejected|rolled_back|failed)")
_M_SWAP_PAUSE = _REG.histogram(
    "serving_swap_pause_seconds",
    "decode-loop pause while a staged weight swap lands between "
    "iterations, by model")
_M_SWAP_STEP = _REG.gauge(
    "serving_swap_step",
    "checkpoint step of the live serving weights, by model "
    "(-1 until a hot-swap lands)")
_M_RESTARTS = _REG.counter(
    "serving_restart_total",
    "watchdog engine restarts by model and reason; in-flight requests "
    "requeue through the preemption path")
_M_SUSPENDED = _REG.gauge(
    "serving_suspended",
    "1 while admission is suspended under memory pressure, by model")


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
        self._reserved: List[int] = []
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

    @property
    def reserved_pages(self) -> int:
        return len(self._reserved)

    def reserve(self, n: int) -> int:
        """Park up to `n` FREE pages out of circulation (memory-pressure
        degradation: a reserved page cannot be allocated until released).
        Live pages are never touched. Returns the count reserved."""
        take = min(max(0, int(n)), len(self._free))
        for _ in range(take):
            self._reserved.append(self._free.pop())
        return take

    def release_reserved(self, n: Optional[int] = None) -> int:
        """Return reserved pages to the free list (all by default)."""
        take = len(self._reserved) if n is None \
            else min(max(0, int(n)), len(self._reserved))
        for _ in range(take):
            self._free.append(self._reserved.pop())
        return take


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


class _PrefillBuffers:
    """The captured prefill's static inputs and output for one prompt
    bucket, the counterpart of :class:`_LaneBuffers`.

    One pinned host block and its device twin hold [bucket + 6] int64
    (the prompt ids, then slot, length, write_start, top_k, seed and
    step), [2] float32 (temperature, top_p) and [pages_per_seq] int32
    (the block-table row), so an admission moves them in one copy. The
    step writes the first token into ``out`` [1] int32, which comes back
    into the pinned ``out_host``."""

    def __init__(self, bucket: int, pages_per_seq: int,
                 device: torch.device):
        pin = device.type == "cuda"
        n_int = bucket + 6
        size = 8 * n_int + 8 + 4 * pages_per_seq
        self.host = torch.zeros(size, dtype=torch.uint8, pin_memory=pin)
        self.dev = torch.zeros(size, dtype=torch.uint8, device=device)
        h = self.host.numpy()
        self.host_ints = h[:8 * n_int].view(np.int64)
        self.host_floats = h[8 * n_int:8 * n_int + 8].view(np.float32)
        self.host_row = h[8 * n_int + 8:].view(np.int32)
        ints = self.dev[:8 * n_int].view(torch.int64)
        floats = self.dev[8 * n_int:8 * n_int + 8].view(torch.float32)
        self.ids = ints[:bucket].view(1, bucket)
        self.slot, self.length, self.write_start = (
            ints[bucket], ints[bucket + 1], ints[bucket + 2])
        self.top_k, self.seed, self.step = (
            ints[bucket + 3:bucket + 4], ints[bucket + 4:bucket + 5],
            ints[bucket + 5:bucket + 6])
        self.temp, self.top_p = floats[0:1], floats[1:2]
        self.row = self.dev[8 * n_int + 8:].view(torch.int32)
        self.out = torch.zeros(1, dtype=torch.int32, device=device)
        self.out_host = torch.zeros(1, dtype=torch.int32, pin_memory=pin)

    def fill(self, tokens: Sequence[int], pages: Sequence[int], slot: int,
             write_start: int, sp: SamplingParams, seed: int, step: int):
        bucket = self.ids.shape[1]
        n = len(tokens)
        self.host_ints[:n] = tokens
        self.host_ints[n:bucket] = 0
        self.host_ints[bucket:] = (slot, n, write_start, sp.top_k, seed,
                                   step)
        self.host_floats[:] = (sp.temperature, sp.top_p)
        self.host_row[:] = 0
        self.host_row[:len(pages)] = pages


class _LossOf(torch.nn.Module):
    """``model.loss`` as a module's forward, so ``functional_call`` can
    run it over candidate weights (``model.<name>`` for each name)."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, ids, labels):
        return self.model.loss(ids, labels)


def _torch_dtype(t) -> Optional[torch.dtype]:
    """A candidate weight's type as a torch dtype (None when torch has
    none for it)."""
    if isinstance(t, torch.Tensor):
        return t.dtype
    try:
        return torch.from_numpy(np.empty(0, np.dtype(t.dtype))).dtype
    except TypeError:
        return None


def _as_tensor(t) -> torch.Tensor:
    return t if isinstance(t, torch.Tensor) else torch.tensor(np.asarray(t))


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

    `decode_mode`: "fused" (default) runs each decode iteration and each
    prefill as one step over static buffers, on a card one CUDA graph per
    (lane bucket, greedy or sampling variant) and per ("prefill", prompt
    bucket, variant), all captured at first use into one pool; a failed
    capture or replay raises. The steps run with the per-op NaN check
    suspended (the reference's check does not look inside its jitted
    executables either). "eager" dispatches the same math op by op,
    prefill included (the reference jits prefill in both modes). Both
    modes give the same tokens, bit for bit.

    The self-healing plane: `request_swap` stages new weights (copied to
    the device at once) and the next iteration boundary copies them into
    the live parameters in place, keeping the outgoing set for
    `rollback_weights`; `run_canary` scores weights without touching the
    live ones; `restart` requeues the in-flight requests and resets the
    KV plane in place; `suspend`, `set_queue_limit` and `shrink_pool` gate
    admission (the MemoryGovernor's ladder). The disaggregated pipeline's
    hooks (`admit_handoff`, `handoff_source`, `on_preempt_requeue`),
    `audit()` and the fleet leader's `term=` fencing raise, naming the
    ROADMAP items that port them.

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
        # the captured prefill: static buffers per prompt bucket, graphs
        # in the same StepGraphs (and pool) as the decode step's
        self._prefill_bufs: Dict[int, _PrefillBuffers] = {}
        self._step_graphs = (StepGraphs(self.device, f"ServingEngine {name}")
                             if self.device.type == "cuda" else None)
        # the live weights, written in place by a swap (a captured graph
        # reads them at their addresses)
        self._params = dict(model.named_parameters())
        self._buffers = dict(model.named_buffers())
        self._loop_poll_s = 0.005
        # self-healing plane state: the staged swap (applied between
        # iterations), the outgoing weights kept for rollback, the restart
        # flag, and the shed/suspend admission gates. The dispatch lock
        # keeps a canary (which rebinds the model's attributes while it
        # runs) out of every prefill, decode step and capture.
        self._swap_lock = threading.Lock()
        self._dispatch_lock = threading.Lock()
        self._pending_swap: Optional[dict] = None
        self._prev_weights: Optional[tuple] = None
        self.weights_step: Optional[int] = None
        self.last_swap: Optional[dict] = None
        self._restarting = False
        self.queue_limit: Optional[int] = None
        self._suspended: Optional[dict] = None
        self.stats = {"iterations": 0, "prefills": 0, "decode_tokens": 0,
                      "completed": 0, "preemptions": 0, "decode_wall_s": 0.0,
                      "prefill_wall_s": 0.0, "cow_copies": 0,
                      "prefix_hit_tokens": 0, "shared_admissions": 0,
                      "swaps": 0, "restarts": 0, "graph_captures": 0,
                      "prefill_graph_replays": 0,
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

    # -- the reference's surface the port does not carry ----------------------
    def tp_degree(self) -> int:
        """Shards the KV pools split over: 1 (no tensor-parallel mesh)."""
        return 1

    def audit(self, emit: bool = True):
        raise NotImplementedError(
            "ServingEngine.audit: the static program audit (the reference's "
            "jaxpr auditor) is not ported (ROADMAP A13)")

    def admit_handoff(self, handoff) -> bool:
        raise NotImplementedError(
            "ServingEngine.admit_handoff: the disaggregated prefill/decode "
            "pipeline (inference/disagg.py) is not ported (ROADMAP A11)")

    @property
    def handoff_source(self):
        return None

    @handoff_source.setter
    def handoff_source(self, value):
        if value is not None:
            raise NotImplementedError(
                "ServingEngine.handoff_source: the disaggregated "
                "pipeline is not ported (ROADMAP A11)")

    @property
    def on_preempt_requeue(self):
        return None

    @on_preempt_requeue.setter
    def on_preempt_requeue(self, value):
        if value is not None:
            raise NotImplementedError(
                "ServingEngine.on_preempt_requeue: the disaggregated "
                "pipeline is not ported (ROADMAP A11)")

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
        susp = self._suspended
        if susp is not None:
            raise EngineSuspended(self.name, susp["reason"],
                                  susp["retry_after_s"])
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
            if self.queue_limit is not None \
                    and len(self._queue) >= self.queue_limit:
                # controller shed: sustained SLO breach capped the queue
                raise RuntimeError(
                    f"queue at shed cap ({self.queue_limit}); "
                    f"engine {self.name!r} is shedding load")
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
        # chaos: an armed `serving.wedge=N:delay` stalls the loop here,
        # before any progress is made; `wedged()` flips once the stall
        # outlives the liveness window (the watchdog-restart drill)
        try:
            _fault_site("serving.wedge")
        except Exception:
            pass  # delay/no-op kinds only; a wedge is slow, not dead
        # a staged weight swap lands at the iteration boundary: in-flight
        # requests keep their pages and decode the next token on the new
        # weights, and no graph is captured again
        if self._pending_swap is not None:
            self._apply_pending_swap()
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
        self._loop_poll_s = poll_s

        def loop():
            while not self._closed and not self._restarting:
                try:
                    if self._pending_swap is not None and \
                            not self.pending():
                        self._apply_pending_swap()  # idle engines swap too
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

    # -- self-healing plane: swap / restart / degradation ---------------------
    def request_swap(self, params: Dict, buffers: Optional[Dict] = None, *,
                     step: Optional[int] = None, source: str = "manual",
                     rollback: bool = False, on_applied=None) -> dict:
        """Stage a replacement weight set ({name: tensor or array}); it is
        copied into the live parameters at the next decode-iteration
        boundary (`step()` / the idle loop). The arrays are validated
        against the live weights here: a missing parameter or a shape or
        type mismatch raises and nothing is staged. The candidate is
        copied to device tensors now, off the decode path, beside a
        transient set the apply exchanges through (so while a swap is
        pending the engine holds two more weight sets, and after it one:
        the rollback set). Returns the staged record; a second stage
        before the apply replaces the first."""
        for k, live in self._params.items():
            cand = params.get(k)
            if cand is None:
                raise ValueError(f"swap rejected: missing parameter {k!r}")
            if tuple(cand.shape) != tuple(live.shape) \
                    or _torch_dtype(cand) != live.dtype:
                raise ValueError(
                    f"swap rejected: parameter {k!r} is "
                    f"{tuple(cand.shape)}/{cand.dtype} but the live "
                    f"weights hold {tuple(live.shape)}/{live.dtype}")
        if buffers is not None:
            for k, live in self._buffers.items():
                cand = buffers.get(k)
                if cand is not None \
                        and tuple(cand.shape) != tuple(live.shape):
                    raise ValueError(
                        f"swap rejected: buffer {k!r} shape "
                        f"{tuple(cand.shape)} != {tuple(live.shape)}")
        with torch.no_grad():
            staged = {k: torch.empty_like(live).copy_(_as_tensor(params[k]))
                      for k, live in self._params.items()}
            staged_b = None if buffers is None else {
                k: torch.empty_like(live).copy_(_as_tensor(buffers[k]))
                for k, live in self._buffers.items() if k in buffers}
        return self._stage(staged, staged_b, step, source, rollback,
                           on_applied)

    def _stage(self, params, buffers, step, source, rollback, on_applied):
        # the apply's exchange goes through a transient set, allocated
        # here, off the decode path, and dropped after the apply
        held = [[torch.empty_like(t) for t in staged.values()]
                for staged in (params, buffers or {})]
        ready = None
        if self.device.type == "cuda":
            # the apply, on the loop's stream, waits for these copies
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        pend = {"params": params, "buffers": buffers, "held": held,
                "step": step, "source": source, "rollback": bool(rollback),
                "on_applied": on_applied, "ready": ready,
                "staged_ts": time.time()}
        with self._swap_lock:
            self._pending_swap = pend
        _events.emit("serving_swap", severity="info", action="stage",
                     model=self.name, to_step=step, source=source,
                     rollback=bool(rollback))
        return pend

    def _apply_pending_swap(self) -> Optional[dict]:
        """Copy the staged weights into the live parameters and buffers,
        in place, on the stream the steps run on, and the outgoing ones
        into the staged tensors, which become the rollback set. No
        tensor is rebound: every captured graph sees the new weights."""
        with self._swap_lock:
            pend, self._pending_swap = self._pending_swap, None
        if pend is None:
            return None
        from_step = self.weights_step
        t0 = time.perf_counter()
        with self._dispatch_lock, torch.no_grad():
            if pend["ready"] is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(pend["ready"])
            for live, staged, held in zip(
                    (self._params, self._buffers),
                    (pend["params"], pend["buffers"] or {}), pend["held"]):
                if not staged:
                    continue
                # three multi-tensor copies through the transient set
                dst = [live[k] for k in staged]
                src = list(staged.values())
                torch._foreach_copy_(held, dst)
                torch._foreach_copy_(dst, src)
                torch._foreach_copy_(src, held)
            if pend["ready"] is not None:
                stream.synchronize()  # before the transient set goes
            del pend["held"]
            self._prev_weights = (pend["params"], pend["buffers"],
                                  from_step)
            self.weights_step = pend["step"]
        pause_s = time.perf_counter() - t0
        self.stats["swaps"] += 1
        action = "rollback" if pend["rollback"] else "swap"
        in_flight = sum(r is not None for r in self._slots)
        self.last_swap = {"action": action, "step": pend["step"],
                          "from_step": from_step, "pause_s": pause_s,
                          "ts": time.time(), "source": pend["source"],
                          "in_flight": in_flight}
        if _metrics.enabled():
            outcome = "rolled_back" if pend["rollback"] else "applied"
            _M_SWAP_TOTAL.inc(1.0, model=self.name, outcome=outcome)
            _M_SWAP_PAUSE.observe(pause_s, model=self.name)
            _M_SWAP_STEP.set(-1 if pend["step"] is None else pend["step"],
                             model=self.name)
        _events.emit("serving_swap",
                     severity="warn" if pend["rollback"] else "info",
                     action=action, model=self.name,
                     from_step=from_step, to_step=pend["step"],
                     pause_s=round(pause_s, 6), source=pend["source"],
                     in_flight=in_flight)
        cb = pend.get("on_applied")
        if cb is not None:
            try:
                cb(self.last_swap)
            except Exception:  # noqa: BLE001 — observer must not kill decode
                pass
        return self.last_swap

    def rollback_weights(self, *, source: str = "rollback") -> dict:
        """Stage the previous weight set back in (the set the last swap
        replaced, held in the tensors it was staged in). Raises when no
        swap has happened yet."""
        if self._prev_weights is None:
            raise RuntimeError("no previous weights to roll back to")
        params, buffers, step = self._prev_weights
        return self._stage(params, buffers, step, source, True, None)

    def run_canary(self, probe_ids, params: Optional[Dict] = None,
                   buffers: Optional[Dict] = None) -> float:
        """Mean-token perplexity of the probe batch (B, T >= 2) under the
        given weights (default: the live weights), the swap canary's
        score: ``exp(model.loss(ids[:, :-1], ids[:, 1:]))``. Candidate
        weights go in through ``torch.func.functional_call``, so the live
        storage is never written; it serializes with the steps through
        the dispatch lock, as the module's attributes are rebound while
        it runs."""
        ids = np.asarray(probe_ids, np.int64)
        if ids.ndim != 2 or ids.shape[1] < 2:
            raise ValueError("probe batch must be (B, T>=2) token ids")
        inp = torch.from_numpy(ids[:, :-1].copy()).to(self.device)
        lbl = torch.from_numpy(ids[:, 1:].copy()).to(self.device)
        cand = {}
        for live, given in ((self._params, params), (self._buffers,
                                                     buffers)):
            for k, v in (given or {}).items():
                if k in live:
                    cand[f"model.{k}"] = _as_tensor(v).to(
                        device=self.device, dtype=live[k].dtype)
        with self._dispatch_lock, torch.no_grad():
            if cand:
                loss = torch.func.functional_call(_LossOf(self.model), cand,
                                                  (inp, lbl))
            else:
                loss = self.model.loss(inp, lbl)
        nll = float(loss)
        try:
            return math.exp(nll)  # a confidently-wrong push overflows
        except OverflowError:
            return float("inf")

    def last_progress_age(self) -> float:
        """Seconds since the last completed decode iteration (the
        serving-liveness signal)."""
        return time.monotonic() - self._last_progress

    def restart(self, reason: str = "wedged", join_timeout: float = 15.0,
                term: Optional[int] = None) -> dict:
        """Watchdog restart: stop the decode loop, requeue every in-flight
        request through the preemption path (trace ids and generated
        prefixes kept: recompute-style resume), rebuild the allocator and
        the prefix registry (parked pages stay parked), zero the KV pools,
        block tables and context lengths in place, and relaunch the loop
        if one ran. Queued requests are untouched; no graph is captured
        again. Raises if the loop does not stop within `join_timeout`.
        `term` other than None raises (the leader's fencing, A12)."""
        _no_fencing(term, "serving_restart")
        if self._closed:
            raise RuntimeError("engine is closed")
        was_running = self._thread is not None
        self._restarting = True
        try:
            t = self._thread
            if t is not None:
                t.join(join_timeout)
                if t.is_alive():
                    raise RuntimeError(
                        f"decode loop did not stop within {join_timeout}s")
                self._thread = None
            requeued = 0
            for req in [r for r in self._slots if r is not None]:
                self._preempt(req)
                requeued += 1
            leaked = self.allocator.outstanding()
            reserved = self.allocator.reserved_pages
            self._prefix = _PrefixCache(self.page_size)
            with self._dispatch_lock:
                for kv in (*self.cache.k_pages, *self.cache.v_pages,
                           self.cache.block_tables, self.cache.context_lens):
                    kv.zero_()
            self.allocator = PageAllocator(self.cache.num_pages,
                                           on_release=self._prefix.drop_page)
            if reserved:
                self.allocator.reserve(reserved)  # keep the shrink in force
            self._cur_tokens[:] = 0
            self.stats["restarts"] += 1
            self._last_progress = time.monotonic()
        finally:
            self._restarting = False
        if _metrics.enabled():
            _M_RESTARTS.inc(1.0, model=self.name, reason=reason)
        _events.emit("serving_restart", model=self.name, reason=reason,
                     requeued=requeued, leaked_pages=len(leaked),
                     restarted_thread=was_running)
        if was_running:
            self.start(self._loop_poll_s)
        return {"requeued": requeued, "leaked_pages": len(leaked),
                "restarted_thread": was_running}

    def set_queue_limit(self, limit: Optional[int],
                        term: Optional[int] = None):
        """Controller shed actuation: cap (or uncap) queue admission.
        `term` other than None raises (the leader's fencing, A12)."""
        _no_fencing(term, "serving_shed")
        self.queue_limit = None if limit is None else max(1, int(limit))

    def suspend(self, reason: str = "memory_pressure",
                retry_after_s: Optional[float] = None):
        """Refuse new admissions (EngineSuspended carries Retry-After);
        queued and in-flight work keeps draining."""
        if retry_after_s is None:
            retry_after_s = env_float("PADDLE_TPU_SERVING_RETRY_AFTER_SEC",
                                      5.0)
        self._suspended = {"reason": reason,
                           "retry_after_s": float(retry_after_s),
                           "ts": time.time()}
        if _metrics.enabled():
            _M_SUSPENDED.set(1, model=self.name)

    def resume_admissions(self):
        self._suspended = None
        if _metrics.enabled():
            _M_SUSPENDED.set(0, model=self.name)

    def shrink_pool(self, frac: float = 0.5) -> int:
        """Park up to `frac` of the pool's pages (taken from the free
        list) out of circulation, the first memory-pressure rung. Returns
        the pages parked (live pages never move)."""
        target = max(1, int((self.cache.num_pages - 1) * frac))
        return self.allocator.reserve(target)

    def restore_pool(self) -> int:
        """Return every parked page to the free list (pressure cleared)."""
        return self.allocator.release_reserved()

    def wedged(self, stall_after: Optional[float] = None) -> bool:
        """True when the engine holds work but has not completed a decode
        iteration for `stall_after` seconds (default: the stall threshold
        PADDLE_TPU_HEALTH_STALL_SEC)."""
        if stall_after is None:
            stall_after = env_float("PADDLE_TPU_HEALTH_STALL_SEC", 300.0)
        if not self.pending():
            return False
        if self._closed:
            return True
        return (time.monotonic() - self._last_progress) > stall_after

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
        """The reference's status keys (no tensor-parallel mesh), plus the
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
                "reserved_pages": self.allocator.reserved_pages,
                "queue_limit": self.queue_limit,
                "suspended": dict(self._suspended) if self._suspended
                             else None,
                "weights_step": self.weights_step,
                "last_swap": dict(self.last_swap) if self.last_swap
                             else None,
                "stats": dict(self.stats),
                "device": str(self.device),
                "graphs": len(self._graphs),
            }

    @property
    def _graphs(self) -> dict:
        """{(lane bucket, variant) or ("prefill", prompt bucket, variant):
        (graph, launch counts, outputs)}; empty on the CPU."""
        g = self._step_graphs
        return {} if g is None else g.graphs

    @property
    def graph_replays(self) -> Dict[tuple, int]:
        g = self._step_graphs
        return {} if g is None else g.replays

    @property
    def graph_pool_bytes(self) -> int:
        g = self._step_graphs
        return 0 if g is None else g.pool_bytes

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
        shared length. Each prefill ends with its first token back on the
        host (the prefill boundary)."""
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
            t0 = time.perf_counter()
            # the FIRST generated token is sampled like every other (step
            # counter 0, or len(generated) after a preemption)
            prefill = (self._fused_prefill if self.decode_mode == "fused"
                       else self._eager_prefill)
            # the padded ids' signature: one a bucket
            self._observe_site(f"prefill:{self.name}", (1, bucket))
            prev = _compile_watch.push_entry(
                "to_static", f"serving_prefill:{self.name}")
            try:
                tok = prefill(req, tokens, pages, slot, bucket, shared_len)
            finally:
                _compile_watch.pop_entry(prev)
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

    def _eager_prefill(self, req: Request, tokens, pages, slot: int,
                       bucket: int, shared_len: int) -> int:
        """The prefill dispatched op by op: the block-table row, the
        prompt's forward with host ints, the draw from host lists."""
        row = np.zeros((self.cache.pages_per_seq,), np.int32)
        row[:len(pages)] = pages
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :len(tokens)] = tokens
        sp = req.sampling
        with self._dispatch_lock, torch.no_grad():
            self.cache.block_tables[slot] = torch.from_numpy(row).to(
                self.device)
            logits, _ = self.model.forward_prefill(
                torch.from_numpy(ids).to(self.device), self.cache, slot,
                len(tokens), write_start=shared_len)
            nxt = sample_logits(logits, [sp.temperature], [sp.top_k],
                                [sp.top_p], [req.seed],
                                [len(req.generated)])
            return int(nxt[0])  # device sync: the prefill boundary

    def _prefill_fn(self, buf: _PrefillBuffers, sampled: bool):
        """The prefill over `buf`'s static tensors (the counterpart of the
        reference's ``_prefill_fn``): the slot's block-table row, every
        layer with the K/V written into the pages (positions outside
        [write_start, length) to the null page), and the first token's
        draw into ``buf.out``. Nothing in it reads a host value, so a
        replay serves any length, slot and shared prefix of its bucket.
        The per-op NaN check is suspended, as in the decode step."""
        with torch.no_grad(), _health.suspended():
            self.cache.block_tables.index_copy_(0, buf.slot.view(1),
                                                buf.row.view(1, -1))
            logits, _ = self.model.forward_prefill(
                buf.ids, self.cache, buf.slot, buf.length,
                write_start=buf.write_start)
            buf.out.copy_(sample_logits(logits, buf.temp, buf.top_k,
                                        buf.top_p, buf.seed, buf.step,
                                        sampled=sampled))

    def _fused_prefill(self, req: Request, tokens, pages, slot: int,
                       bucket: int, shared_len: int) -> int:
        """One host-to-device copy of the admission's inputs into the
        bucket's static buffers, the prefill (a graph replay on a card,
        captured at the (bucket, variant)'s first use; a plain call on
        the CPU), and one copy of the token back."""
        if not 1 <= len(tokens) <= bucket:
            raise ValueError(f"prefill: {len(tokens)} tokens outside the "
                             f"bucket [1, {bucket}]")
        buf = self._prefill_bufs.get(bucket)
        if buf is None:
            buf = self._prefill_bufs[bucket] = _PrefillBuffers(
                bucket, self.cache.pages_per_seq, self.device)
        sp = req.sampling
        buf.fill(tokens, pages, slot, shared_len, sp, req.seed,
                 len(req.generated))
        sampled = not sp.greedy
        with self._dispatch_lock:
            buf.dev.copy_(buf.host, non_blocking=True)
            graphs = self._step_graphs
            if graphs is None:
                self._prefill_fn(buf, sampled)
                return int(buf.out[0])
            key = ("prefill", bucket, "sampled" if sampled else "greedy")
            replay = key in graphs.graphs
            captures = graphs.captures
            graphs.run(key, lambda: self._prefill_fn(buf, sampled))
            self.stats["graph_captures"] += graphs.captures - captures
            self.stats["prefill_graph_replays"] += int(replay)
            buf.out_host.copy_(buf.out, non_blocking=True)
            self._sync()
            return int(buf.out_host[0])

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
        # per-bucket watchdog site: ONE signature per lane width is the
        # zero-retrace steady-state contract
        self._observe_site(f"decode:{self.name}:w{W}", (W,))
        prev = _compile_watch.push_entry("to_static",
                                         f"serving_decode:{self.name}")
        t0 = time.perf_counter()
        try:
            with self._dispatch_lock:
                if self.decode_mode == "fused":
                    nxt_np = self._fused_iteration(lanes, sampled)
                else:
                    nxt_np = self._eager_iteration(lanes, sampled)
        finally:
            _compile_watch.pop_entry(prev)
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

    @staticmethod
    def _observe_site(site: str, shape) -> None:
        """One lookup of the retrace watchdog at a graph site: the int64
        token tensor of `shape` (the reference observes the same tensor,
        as ``to_static`` ``serving_<site>``)."""
        _get_watchdog().observe("to_static", f"serving_{site}",
                                signature=(((tuple(shape), "int64"),), ""))

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
        if self._step_graphs is None:
            self._step_fn(buf, sampled)
            return buf.out.numpy().copy()
        key = (W, "sampled" if sampled else "greedy")
        captures = self._step_graphs.captures
        self._step_graphs.run(key, lambda: self._step_fn(buf, sampled))
        self.stats["graph_captures"] += self._step_graphs.captures - captures
        buf.out_host.copy_(buf.out, non_blocking=True)
        self._sync()
        return buf.out_host.numpy().copy()

    def _sync(self):
        """Wait for the steps' stream (the iteration or prefill
        boundary)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

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
