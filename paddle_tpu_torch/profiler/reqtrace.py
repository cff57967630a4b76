"""Request-scoped serving traces: per-request lifecycle spans for the
continuous-batching engine (a copy of ``paddle_tpu/profiler/reqtrace.py``
on the port's envparse, events and metrics modules).

The serving stack reports aggregate `serving_ttft/tpot` histograms, but
once a request enters the decode loop its queue wait, prefill, per-
iteration decode, and preemptions are invisible. This module is the
per-request signal plane: the ServingEngine calls into a
:class:`RequestTracer` at each lifecycle transition and the tracer
records spans —

    queued -> admitted -> prefill (shared-prefix skip noted)
           -> decode (bucketed per N iterations, labeled bucket/path)
           -> preempt/requeue (SAME trace id across the re-prefill)
           -> complete | failed

— into a bounded ring of completed traces, exportable as chrome-trace
JSON (``chrome://tracing`` / Perfetto) and JSONL. Per-phase durations
feed three histogram families the aggregate plane was missing:
`serving_queue_wait_seconds`, `serving_prefill_seconds`, and
`serving_preempt_requeue_seconds`.

Knobs (all envparse'd):

    PADDLE_TPU_REQTRACE=0          kill switch: every hook is a no-op
    PADDLE_TPU_REQTRACE_RING=256   completed traces kept in memory
    PADDLE_TPU_REQTRACE_EVERY=8    decode-iteration span bucketing: one
                                   `decode` span per N iterations
    PADDLE_TPU_REQTRACE_LOG=path   append one JSON line per completed
                                   trace (the offline input)

Each completed trace also emits ONE `request_trace` structured event
(registered in events.KIND_SEVERITY) carrying the phase breakdown, so
``events.recent(kind="request_trace")`` sees per-request latency
attribution without scraping the ring.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..utils.envparse import env_bool, env_int, env_str
from . import events as _events
from . import metrics as _metrics

__all__ = ["RequestTracer", "Trace", "default_tracer", "enabled",
           "to_chrome_trace", "PHASES"]

#: canonical lifecycle phase names, in order of first appearance
PHASES = ("queued", "prefill", "decode", "preempted", "complete", "failed")

_REG = _metrics.default_registry()
_M_QWAIT = _REG.histogram(
    "serving_queue_wait_seconds",
    "seconds a request waited in the admission queue before prefill, "
    "by model; re-admissions after preemption observe again")
_M_PREFILL = _REG.histogram(
    "serving_prefill_seconds",
    "prefill (prompt ingestion) seconds per admission, by model")
_M_REQUEUE = _REG.histogram(
    "serving_preempt_requeue_seconds",
    "seconds between a preemption and the request's re-admission "
    "(recompute requeue wait), by model")

_trace_ids = itertools.count(1)


def enabled() -> bool:
    """Kill switch: PADDLE_TPU_REQTRACE=0 disables every tracer hook."""
    return env_bool("PADDLE_TPU_REQTRACE", True)


class Trace:
    """One request's lifecycle: an ordered list of spans sharing one id.

    A span is ``{"phase", "start", "end", ...labels}`` with monotonic
    timestamps; ``end`` is None while the span is open. The SAME Trace
    object (and trace id) survives preemption + re-prefill.
    """

    __slots__ = ("trace_id", "rid", "model", "submitted_ts", "done_ts",
                 "spans", "state", "finish_reason", "preemptions",
                 "decode_iterations", "decode_tokens", "shared_tokens")

    def __init__(self, trace_id: int, rid: int, model: str):
        self.trace_id = trace_id
        self.rid = rid
        self.model = model
        self.submitted_ts = time.monotonic()
        self.done_ts: Optional[float] = None
        self.spans: List[dict] = []
        self.state = "queued"
        self.finish_reason: Optional[str] = None
        self.preemptions = 0
        self.decode_iterations = 0
        self.decode_tokens = 0
        self.shared_tokens = 0

    # -- span plumbing -------------------------------------------------------
    def open_span(self, phase: str, **labels) -> dict:
        span = {"phase": phase, "start": time.monotonic(), "end": None}
        span.update(labels)
        self.spans.append(span)
        return span

    def close_span(self, phase: Optional[str] = None) -> Optional[dict]:
        """Close the most recent open span (optionally of `phase`)."""
        for span in reversed(self.spans):
            if span["end"] is None and (phase is None
                                        or span["phase"] == phase):
                span["end"] = time.monotonic()
                return span
        return None

    def open_spans(self) -> List[dict]:
        return [s for s in self.spans if s["end"] is None]

    # -- derived views -------------------------------------------------------
    def phase_durations(self) -> Dict[str, float]:
        """Total seconds per phase (closed spans only)."""
        out: Dict[str, float] = {}
        for s in self.spans:
            if s["end"] is not None:
                out[s["phase"]] = out.get(s["phase"], 0.0) \
                    + (s["end"] - s["start"])
        return out

    def e2e_s(self) -> Optional[float]:
        if self.done_ts is None:
            return None
        return self.done_ts - self.submitted_ts

    def to_dict(self) -> dict:
        """JSON-serializable trace record (the JSONL line shape)."""
        return {
            "trace_id": self.trace_id,
            "rid": self.rid,
            "model": self.model,
            "state": self.state,
            "finish_reason": self.finish_reason,
            "preemptions": self.preemptions,
            "decode_iterations": self.decode_iterations,
            "decode_tokens": self.decode_tokens,
            "shared_tokens": self.shared_tokens,
            "e2e_s": self.e2e_s(),
            "phases": self.phase_durations(),
            "spans": [dict(s) for s in self.spans],
        }


class RequestTracer:
    """Assigns trace ids and records lifecycle spans for serving requests.

    The engine owns one tracer; every hook is cheap (dict/list ops under
    one lock) and a no-op when the kill switch is off. Completed traces
    land in a bounded ring; live traces are keyed by request id.
    """

    def __init__(self, model: str = "gpt", *,
                 ring: Optional[int] = None,
                 decode_every: Optional[int] = None,
                 log_path: Optional[str] = None):
        self.model = model
        self._ring_size = (env_int("PADDLE_TPU_REQTRACE_RING", 256)
                           if ring is None else int(ring))
        self.decode_every = max(1, env_int("PADDLE_TPU_REQTRACE_EVERY", 8)
                                if decode_every is None else int(decode_every))
        self._log_path = (env_str("PADDLE_TPU_REQTRACE_LOG")
                          if log_path is None else log_path)
        self._lock = threading.Lock()
        self._live: Dict[int, Trace] = {}
        self._done: "deque[Trace]" = deque(maxlen=max(1, self._ring_size))

    # -- lifecycle hooks (called by ServingEngine) ---------------------------
    def submit(self, rid: int) -> Optional[int]:
        """Request entered the admission queue; opens the `queued` span
        and returns the assigned trace id (None when disabled)."""
        if not enabled():
            return None
        with self._lock:
            tr = Trace(next(_trace_ids), rid, self.model)
            tr.open_span("queued")
            self._live[rid] = tr
            return tr.trace_id

    def admitted(self, rid: int, *, bucket: int, prompt_tokens: int,
                 shared_tokens: int = 0, requeue: bool = False):
        """Queue wait ended, prefill starts. `requeue=True` marks a
        re-admission after preemption: the re-prefill span is labeled
        and the requeue wait feeds its own histogram family."""
        tr = self._live.get(rid)
        if tr is None:
            return
        with self._lock:
            now = time.monotonic()
            span = tr.close_span("preempted" if requeue else "queued")
            wait = (now - span["start"]) if span else 0.0
            if _metrics.enabled():
                if requeue:
                    _M_REQUEUE.observe(wait, model=self.model)
                else:
                    _M_QWAIT.observe(wait, model=self.model)
            tr.state = "running"
            tr.shared_tokens = max(tr.shared_tokens, int(shared_tokens))
            labels = {"bucket": int(bucket),
                      "prompt_tokens": int(prompt_tokens)}
            if shared_tokens:
                labels["shared_prefix_skip"] = int(shared_tokens)
            if requeue:
                labels["requeue"] = True
            tr.open_span("prefill", **labels)

    def prefill_done(self, rid: int):
        tr = self._live.get(rid)
        if tr is None:
            return
        with self._lock:
            span = tr.close_span("prefill")
            if span is not None and _metrics.enabled():
                _M_PREFILL.observe(span["end"] - span["start"],
                                   model=self.model)

    def decode_iteration(self, rid: int, *, bucket: int, path: str,
                         tokens: int = 1):
        """One decode iteration for this request. Spans are bucketed:
        a `decode` span stays open across `decode_every` iterations (or
        until the bucket/path labels change) to bound span count."""
        tr = self._live.get(rid)
        if tr is None:
            return
        with self._lock:
            tr.decode_iterations += 1
            tr.decode_tokens += int(tokens)
            now = time.monotonic()
            cur = None
            for s in reversed(tr.spans):
                if s["phase"] == "decode" and s["end"] is None:
                    cur = s
                    break
            if cur is not None and (cur["bucket"] != int(bucket)
                                    or cur["path"] != path
                                    or cur["iters"] >= self.decode_every):
                cur["end"] = now
                cur = None
            if cur is None:
                span = tr.open_span("decode", bucket=int(bucket),
                                    path=path, iters=1)
                # contiguous attribution: a decode span starts where the
                # previous closed span (prefill or the prior decode
                # bucket) ended, so in-batch wait between a request's
                # prefill and its first decode dispatch — time spent
                # waiting on OTHER lanes' prefills — is charged to
                # decode and per-phase durations sum to the e2e wall
                prev_end = max((s["end"] for s in tr.spans
                                if s["end"] is not None), default=None)
                if prev_end is not None and prev_end < span["start"]:
                    span["start"] = prev_end
            else:
                cur["iters"] += 1

    def preempted(self, rid: int):
        """Request was evicted back to the queue (recompute preemption).
        The trace id is KEPT; a `preempted` span stays open until the
        re-admission closes it into serving_preempt_requeue_seconds."""
        tr = self._live.get(rid)
        if tr is None:
            return
        with self._lock:
            for s in tr.open_spans():
                s["end"] = time.monotonic()
            tr.preemptions += 1
            tr.state = "queued"
            tr.open_span("preempted")

    def complete(self, rid: int, reason: str, *,
                 error: Optional[str] = None):
        """Terminal transition: closes every open span, records the
        complete/failed marker span, moves the trace to the ring, emits
        one `request_trace` event, and appends the JSONL line."""
        tr = self._live.pop(rid, None)
        if tr is None:
            return
        with self._lock:
            now = time.monotonic()
            for s in tr.open_spans():
                s["end"] = now
            tr.done_ts = now
            failed = reason == "error" or error is not None
            tr.state = "failed" if failed else "complete"
            tr.finish_reason = reason
            marker = tr.open_span("failed" if failed else "complete")
            if error:
                marker["error"] = str(error)
            marker["start"] = marker["end"] = now  # zero-width marker
            self._done.append(tr)
        rec = tr.to_dict()
        _events.emit("request_trace",
                     severity="warn" if failed else "info",
                     trace_id=tr.trace_id, rid=tr.rid, model=self.model,
                     finish_reason=reason, preemptions=tr.preemptions,
                     decode_tokens=tr.decode_tokens,
                     e2e_s=rec["e2e_s"], phases=rec["phases"])
        if self._log_path:
            try:
                with open(self._log_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            except OSError:
                pass

    # -- views ---------------------------------------------------------------
    def get(self, rid: int) -> Optional[Trace]:
        tr = self._live.get(rid)
        if tr is not None:
            return tr
        with self._lock:
            for t in self._done:
                if t.rid == rid:
                    return t
        return None

    def live(self) -> List[dict]:
        with self._lock:
            return [t.to_dict() for t in self._live.values()]

    def completed(self, n: int = 50) -> List[dict]:
        with self._lock:
            return [t.to_dict() for t in list(self._done)[-max(0, n):]]

    def snapshot(self, n: int = 50) -> dict:
        """Endpoint/bench-serializable view: live + recently completed."""
        return {
            "enabled": enabled(),
            "model": self.model,
            "live": self.live(),
            "completed": self.completed(n),
            "ring_size": self._ring_size,
            "decode_every": self.decode_every,
        }

    def export_jsonl(self, path: str, n: Optional[int] = None) -> int:
        """Write completed traces (oldest first) as JSONL; returns count."""
        recs = self.completed(n if n is not None else self._ring_size)
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
        return len(recs)

    def export_chrome_trace(self, path: str,
                            n: Optional[int] = None) -> int:
        recs = self.completed(n if n is not None else self._ring_size)
        with open(path, "w") as f:
            json.dump(to_chrome_trace(recs), f)
        return len(recs)


def to_chrome_trace(traces: List[dict]) -> dict:
    """Convert trace dicts to the chrome://tracing JSON object format:
    one pid per model, one tid per trace id, complete ("X") events per
    span with phase labels in args."""
    tevents = []
    for t in traces:
        for s in t.get("spans", ()):
            if s.get("end") is None:
                continue
            args = {k: v for k, v in s.items()
                    if k not in ("phase", "start", "end")}
            args["trace_id"] = t["trace_id"]
            args["rid"] = t["rid"]
            tevents.append({
                "name": s["phase"],
                "ph": "X",
                "pid": t.get("model", "serving"),
                "tid": t["trace_id"],
                "ts": s["start"] * 1e6,
                "dur": (s["end"] - s["start"]) * 1e6,
                "args": args,
            })
    return {"traceEvents": tevents, "displayTimeUnit": "ms"}


_default_tracer: Optional[RequestTracer] = None
_default_lock = threading.Lock()


def default_tracer(model: str = "gpt") -> RequestTracer:
    """Process-default tracer; engines construct their own."""
    global _default_tracer
    with _default_lock:
        if _default_tracer is None:
            _default_tracer = RequestTracer(model)
        return _default_tracer
