"""Host event recorder: thread-local span buffers merged on collect.

A copy of ``paddle_tpu/profiler/recorder.py`` (the port imports nothing of
the JAX package), with its drain semantics and its dead-thread pruning.

Reference parity: `paddle/fluid/platform/profiler/host_event_recorder.h`
(thread-local ring buffers of RecordEvent spans) + `event_node.cc` (merge into
an event tree). Here: a per-thread buffer of completed spans; `collect()`
DRAINS all threads' buffers atomically per-thread — each buffer carries its
own lock, `push()` appends under it, and `collect()` swaps the span list out
under the same lock, so a span recorded concurrently with a collect lands in
either this batch or the next, never lost and never duplicated.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class HostSpan:
    name: str
    start_ns: int
    end_ns: int
    tid: int
    event_type: str = "UserDefined"
    parent: Optional[str] = None
    args: Optional[dict] = None   # op metadata: shapes/dtypes/bytes estimate
    device_ns: Optional[int] = None   # device-side execution time
    device_src: Optional[str] = None  # "estimate" | "measured" (device_time)
    #                                 # | "xplane" (xplane.correlate)

    @property
    def dur_ns(self) -> int:
        return self.end_ns - self.start_ns


class _ThreadBuffer:
    __slots__ = ("lock", "spans", "owner", "dropped")

    def __init__(self):
        self.lock = threading.Lock()
        self.spans: List[HostSpan] = []
        self.owner = threading.get_ident()
        self.dropped = False  # pruned from the registry; do not reuse


class HostEventRecorder:
    def __init__(self):
        self._lock = threading.Lock()   # guards the buffer REGISTRY only
        # keyed by buffer identity, NOT thread ident: the OS reuses thread
        # idents, and keying by ident let a new thread's buffer overwrite a
        # dead thread's registry entry while it still held un-collected
        # spans (silent span loss under churning worker threads)
        self._buffers: Dict[int, _ThreadBuffer] = {}
        self._tls = threading.local()
        self.enabled = False

    def _buf(self) -> _ThreadBuffer:
        buf = getattr(self._tls, "buf", None)
        # `dropped` covers a thread the prune misjudged as dead (a foreign
        # thread invisible to threading.enumerate()): it re-registers a
        # fresh buffer instead of pushing into the unreachable old one
        if buf is None or buf.dropped:
            buf = _ThreadBuffer()
            self._tls.buf = buf
            with self._lock:
                self._buffers[id(buf)] = buf
        return buf

    def push(self, span: HostSpan):
        if self.enabled:
            while True:
                buf = self._buf()
                with buf.lock:
                    # re-checked under the lock: a concurrent collect() may
                    # have pruned this buffer between _buf() and here (a
                    # live thread misjudged dead) — appending would orphan
                    # the span, so force a fresh registration instead
                    if not buf.dropped:
                        buf.spans.append(span)
                        return
                self._tls.buf = None

    def collect(self) -> List[HostSpan]:
        """Drain every thread's completed spans (sorted by start time).
        Draining semantics: a second collect() returns only spans recorded
        after the first one. Buffers of threads that have exited are pruned
        AFTER their drain (a dead thread cannot push again), bounding
        registry growth under thread churn."""
        with self._lock:
            items = list(self._buffers.items())
        live = {t.ident for t in threading.enumerate()}
        out: List[HostSpan] = []
        dead = []
        for key, buf in items:
            with buf.lock:
                out.extend(buf.spans)
                buf.spans.clear()
                if buf.owner not in live:
                    buf.dropped = True  # owner re-registers if misjudged
                    dead.append(key)
        if dead:
            with self._lock:
                for key in dead:
                    self._buffers.pop(key, None)
        out.sort(key=lambda s: s.start_ns)
        return out

    def clear(self):
        with self._lock:
            bufs = list(self._buffers.values())
        for buf in bufs:
            with buf.lock:
                buf.spans.clear()

    # active-span stack for nesting info
    def span_stack(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st


_recorder = HostEventRecorder()


def get_recorder() -> HostEventRecorder:
    return _recorder


def now_ns() -> int:
    return time.perf_counter_ns()
