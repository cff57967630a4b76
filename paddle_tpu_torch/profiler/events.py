"""Unified structured event log: one JSONL stream for every runtime event.

A copy of ``paddle_tpu/profiler/events.py`` (the port imports nothing of
the JAX package); the schema and the kinds are the reference's, so the
two packages' event streams read alike. The text below is the
reference's.

PR 2 gave each subsystem its own event shape (watchdog RetraceEvents,
fault-injection warnings, barrier abort warnings, elastic restart
warnings...) — operable only by grepping five different log formats. This
module is the one funnel: watchdog retraces, fault injections, retry
exhaustion, coordinated-checkpoint commits/aborts, elastic restarts,
collective timeouts, device OOMs, XLA compiles, and fleet straggler
detections all `emit()` here with ONE schema, land in a bounded in-memory
ring (served by the ObservabilityServer's `/events` endpoint and folded
into bench JSON), and optionally append to a JSONL file that
`tools/obs_tail.py` tails/filters/pretty-prints.

Schema (flat JSON object per line):

    required  ts: float      unix seconds
              kind: str      ^[a-z][a-z0-9_]*$ (see KINDS for the set the
                             runtime emits today)
              host: str      stable host identity (PADDLE_CURRENT_ENDPOINT,
                             else trainer-<PADDLE_TRAINER_ID>, else
                             <hostname>:<pid>)
    optional  severity: str  debug | info | warn | error (default info)
              ...            kind-specific payload keys, all JSON scalars
                             (lists/dicts allowed but keep events greppable)

`validate_event` is the schema contract tests and
`tools/check_bench_result.py` check against. Kill switch:
`PADDLE_TPU_EVENTS=0` makes every emit a no-op. `PADDLE_TPU_EVENT_LOG=path`
appends each event as one JSON line (the obs_tail input); with
`PADDLE_TPU_EVENT_LOG_MAX_MB=N` the sink rotates size-based (`path` ->
`path.1` -> ... keeping the newest `PADDLE_TPU_EVENT_LOG_KEEP` rotated
files, default 3) so a long fleet run cannot grow the file unboundedly —
`tools/obs_tail.py` reads rotated siblings transparently.
"""
from __future__ import annotations

import json
import os
import re
import socket
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["EventLog", "default_event_log", "emit", "recent",
           "validate_event", "KINDS", "KIND_SEVERITY", "SEVERITIES",
           "host_id"]

#: kinds the runtime emits today -> their DECLARED baseline severity
#: (what the emitter uses in the common case; some kinds escalate, e.g.
#: health_alert warn->error on halt). This table is the source of truth
#: the convention lint (analysis/conventions.py lint_event_kinds) holds
#: every `emit("<kind>", ...)` call site against, and every kind here
#: must render through tools/obs_tail.py (not drop as garbage) — the
#: pairing is pinned by tests/test_conventions.py. Not a closed set for
#: VALIDATION (any ^[a-z][a-z0-9_]*$ name validates, so downstream
#: tooling stays generic) — but a new emitter must register here.
KIND_SEVERITY = {
    "retrace": "info",            # watchdog: new jit signature, warm site
    "xla_compile": "info",        # backend compile, attributed to entry
    "fault_injected": "warn",     # an armed fault site fired
    "retry_exhausted": "error",   # a retried op failed every attempt
    "retry_recovered": "info",    # a retried op succeeded after retries
    "barrier_commit": "info",     # coordinated checkpoint committed
    "barrier_abort": "warn",      # coordinated checkpoint aborted
    "elastic_restart": "warn",    # supervisor relaunched the trainer
    "collective_timeout": "error",  # eager collective blew its deadline
    "device_oom": "error",        # eager op exhausted device memory
    "fleet_straggler": "warn",    # a host's step p50 left the fleet band
    "step_diagnosis": "info",     # step wall-time decomposition
    "profile_capture": "warn",    # a profiler capture session ended
    "tensor_health": "error",     # NaN/Inf detected (sentinel or eager)
    "health_alert": "warn",       # HealthMonitor signal (spike/...)
    "health_rollback": "warn",    # divergence response restored a ckpt
    "fleet_health": "error",      # a host's digest went non-ok
    "controller_decision": "warn",  # controller evict/readmit/rollback
    "elastic_budget_reset": "info",  # healthy window restored the budget
    "serving_admission": "info",  # request entered the decode batch
    "serving_eviction": "info",   # request left the batch (eos/length/
                                  # preempted/failed), pages freed
    "analysis_finding": "warn",   # static program auditor finding
                                  # (severity tracks the finding's own)
    "request_trace": "info",      # a serving request's lifecycle trace
                                  # completed (warn when it failed)
    "slo_breach": "warn",         # a serving SLO window left its target
                                  # (one per excursion; re-arms on
                                  # recovery)
    "serving_swap": "warn",       # weight hot-swap lifecycle (stage/
                                  # swap/reject/rollback/fail/halt)
    "serving_restart": "warn",    # wedged engine restarted; in-flight
                                  # requests requeued, pages rebuilt
    "controller_takeover": "warn",  # a controller acquired the leader
                                    # lease (bootstrap / lease_expired)
    "controller_fenced": "warn",  # stale-term actuation rejected (a
                                  # deposed leader tried to act)
    "fleet_leaderless": "warn",   # no controller renewed the lease for
                                  # over one TTL — failover cover gone
    "disagg_worker_restart": "warn",  # dead/wedged prefill worker
                                      # respawned; its work requeued
}

#: back-compat view: the registered kind names
KINDS = tuple(KIND_SEVERITY)

SEVERITIES = ("debug", "info", "warn", "error")

_KIND_RE = re.compile(r"^[a-z][a-z0-9_]*$")

_RESERVED = ("ts", "kind", "host", "severity")


def host_id() -> str:
    """Stable identity of this process for the `host` field — the same id
    the elastic membership watch uses (PADDLE_CURRENT_ENDPOINT, which
    tools/elastic_run.py pins to trainer-<rank>)."""
    ep = os.environ.get("PADDLE_CURRENT_ENDPOINT")
    if ep:
        return ep
    rank = os.environ.get("PADDLE_TRAINER_ID")
    if rank:
        return f"trainer-{rank}"
    return f"{socket.gethostname()}:{os.getpid()}"


def validate_event(rec: dict) -> dict:
    """Raise ValueError (naming every violation) unless `rec` conforms to
    the event schema; returns the record for chaining."""
    if not isinstance(rec, dict):
        raise ValueError(f"event must be a dict, got {type(rec)}")
    problems = []
    if not isinstance(rec.get("ts"), (int, float)) \
            or isinstance(rec.get("ts"), bool):
        problems.append(f"'ts' must be numeric, got {rec.get('ts')!r}")
    kind = rec.get("kind")
    if not isinstance(kind, str) or not _KIND_RE.match(kind):
        problems.append(f"'kind' must match {_KIND_RE.pattern}, "
                        f"got {kind!r}")
    if not isinstance(rec.get("host"), str) or not rec.get("host"):
        problems.append(f"'host' must be a non-empty string, "
                        f"got {rec.get('host')!r}")
    sev = rec.get("severity", "info")
    if sev not in SEVERITIES:
        problems.append(f"'severity' must be one of {SEVERITIES}, "
                        f"got {sev!r}")
    try:
        json.dumps(rec)
    except (TypeError, ValueError) as e:
        problems.append(f"payload is not JSON-serializable: {e}")
    if problems:
        raise ValueError("invalid event: " + "; ".join(problems))
    return rec


def _enabled() -> bool:
    return os.environ.get("PADDLE_TPU_EVENTS", "1").lower() not in (
        "0", "false", "off", "no")


class EventLog:
    """Bounded ring of structured events + optional JSONL file sink.

    Thread-safe; emit cost with the sink disabled is one dict build + one
    deque append under a lock (events are rare — retraces, faults,
    restarts — never per-op)."""

    def __init__(self, capacity: Optional[int] = None,
                 jsonl_path: Optional[str] = None):
        if capacity is None:
            from ..utils.envparse import env_int
            capacity = env_int("PADDLE_TPU_EVENT_BUFFER", 512)
        self._lock = threading.Lock()
        self._ring: "deque[dict]" = deque(maxlen=max(int(capacity), 1))
        self._counts: Dict[str, int] = {}
        self._path = jsonl_path
        self._file = None
        self._file_error = False

    # -- emission ------------------------------------------------------------
    def emit(self, kind: str, severity: str = "info", **data) -> Optional[dict]:
        """Append one event; returns the record (None when disabled).
        Reserved keys (ts/kind/host/severity) cannot be overridden by
        payload kwargs."""
        if not _enabled():
            return None
        rec = {"ts": time.time(), "kind": kind, "host": host_id(),
               "severity": severity}
        for k, v in data.items():
            if k not in _RESERVED:
                rec[k] = v
        with self._lock:
            self._ring.append(rec)
            self._counts[kind] = self._counts.get(kind, 0) + 1
            self._write_line(rec)
        return rec

    def _write_line(self, rec: dict):
        """Append to the JSONL sink (lazy open; one failure disables the
        sink with a single warning — the ring keeps working). Rotates the
        file size-based when PADDLE_TPU_EVENT_LOG_MAX_MB is set."""
        if self._file_error:
            return
        path = self._path or os.environ.get("PADDLE_TPU_EVENT_LOG")
        if not path:
            return
        try:
            if self._file is None or self._file.name != path:
                if self._file is not None:
                    self._file.close()
                self._file = open(path, "a")
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        except Exception as e:
            self._file_error = True
            import warnings
            warnings.warn(f"event JSONL sink {path!r} failed ({e}); "
                          f"events stay in memory only")
            return
        self._maybe_rotate(path)

    def _maybe_rotate(self, path: str):
        """Size-based rotation: once the sink passes
        PADDLE_TPU_EVENT_LOG_MAX_MB, shift `path` -> `path.1` (existing
        `path.N` -> `path.N+1`, newest-first numbering) and keep only the
        newest PADDLE_TPU_EVENT_LOG_KEEP rotated files. A rotation
        failure never disables the sink — worse to lose events than to
        let the file grow."""
        from ..utils.envparse import env_float, env_int
        max_bytes = env_float("PADDLE_TPU_EVENT_LOG_MAX_MB", 0.0) * (1 << 20)
        if max_bytes <= 0:
            return
        try:
            if self._file.tell() < max_bytes:
                return
            keep = max(0, env_int("PADDLE_TPU_EVENT_LOG_KEEP", 3))
            self._file.close()
            self._file = None  # lazy reopen on the next emit
            oldest = f"{path}.{keep}"
            if keep == 0:
                os.remove(path)
                return
            if os.path.exists(oldest):
                os.remove(oldest)
            for i in range(keep - 1, 0, -1):
                if os.path.exists(f"{path}.{i}"):
                    os.replace(f"{path}.{i}", f"{path}.{i + 1}")
            os.replace(path, f"{path}.1")
        except Exception:
            pass

    # -- reading -------------------------------------------------------------
    def recent(self, n: int = 100, kind: Optional[str] = None,
               min_severity: Optional[str] = None) -> List[dict]:
        """Newest-last list of up to `n` events, optionally filtered."""
        with self._lock:
            events = list(self._ring)
        if kind:
            events = [e for e in events if e.get("kind") == kind]
        if min_severity:
            floor = SEVERITIES.index(min_severity)
            events = [e for e in events
                      if SEVERITIES.index(e.get("severity", "info")) >= floor]
        return events[-max(int(n), 0):]

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._counts.clear()

    def close(self):
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except Exception:
                    pass
                self._file = None


_default = EventLog()


def default_event_log() -> EventLog:
    return _default


def emit(kind: str, severity: str = "info", **data) -> Optional[dict]:
    """Module-level shorthand: `events.emit("retrace", site=..., ...)`."""
    return _default.emit(kind, severity=severity, **data)


def recent(n: int = 100, kind: Optional[str] = None) -> List[dict]:
    return _default.recent(n, kind=kind)
