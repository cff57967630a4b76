"""Recapture/retrace watchdog (counterpart of ``paddle_tpu/profiler/
watchdog.py``).

On the card the silent perf killer is the recapture: a shape/dtype change
slips into a hot loop and the captured step (``jit.TrainStep``, one CUDA
graph per batch signature; the serving engine, one per prefill bucket and
lane bucket) captures a new graph, in a pool of its own, instead of
replaying. This module gives those entry points one place to report their
graph-cache lookups, and turns every NEW signature into a structured
`RetraceEvent` naming the exact delta ("arg0 shape (4, 8)->(6, 8) (dim0
4->6)") against the previous signature for that site+name — the same
strings as the reference's for the same shapes (a tensor's dtype reads
without its ``torch.`` prefix).

Opt-in loudness: `PADDLE_TPU_RETRACE_WARN=N` (or `warn_threshold=N`) logs a
warning through the `paddle_tpu_torch.retrace` logger when one site retraces >= N
times inside a window (`reset_window()` is called per epoch by
`ThroughputMonitor`).

Counters mirrored into the metrics registry (`metrics.py`):
`jit_cache_hits_total{site}`, `jit_cache_misses_total{site}`,
`jit_retraces_total{site}`.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Set, Tuple

from ..utils.envparse import env_int
from . import events as events_mod
from . import metrics as metrics_mod

__all__ = ["RetraceEvent", "RetraceWatchdog", "get_watchdog",
           "describe_delta", "signature_of"]

logger = logging.getLogger("paddle_tpu_torch.retrace")

_REG = metrics_mod.default_registry()
_M_HITS = _REG.counter(
    "jit_cache_hits_total",
    "jit cache lookups that reused a compiled signature, by site")
_M_MISSES = _REG.counter(
    "jit_cache_misses_total",
    "jit cache lookups that required a (re)trace, by site")
_M_RETRACES = _REG.counter(
    "jit_retraces_total",
    "misses whose signature DIFFERS from the site's previous one "
    "(a genuine retrace, not a first compile)")


def _canon_static(v) -> str:
    """Order-insensitive repr of static args: dicts are sorted by key so two
    call sites building the same kwargs in different insertion orders yield
    ONE signature (the reference's eager cache canonicalizes so too —
    a mismatch here reported retraces that never compiled)."""
    if isinstance(v, dict):
        return "{" + ", ".join(f"{k!r}: {_canon_static(x)}"
                               for k, x in sorted(v.items(),
                                                  key=lambda kv: repr(kv[0]))) + "}"
    if isinstance(v, (list, tuple)):
        return "(" + ", ".join(_canon_static(x) for x in v) + ")"
    return repr(v)


def signature_of(arrs: Sequence, static=None) -> tuple:
    """Abstract signature: ((shape, dtype) per input, static-args repr).
    Non-array leaves contribute their type name so a python-scalar change
    is still visible."""
    args_sig = []
    for a in arrs:
        shape = getattr(a, "shape", None)
        if shape is not None:
            dtype = str(getattr(a, "dtype", "?")).replace("torch.", "")
            args_sig.append((tuple(shape), dtype))
        else:
            args_sig.append(((), type(a).__name__))
    return (tuple(args_sig), "" if static is None else _canon_static(static))


def describe_delta(old: tuple, new: tuple) -> str:
    """Human/grep-able description of what changed between two signatures."""
    parts = []
    (oa, ostatic), (na, nstatic) = old, new
    if len(oa) != len(na):
        parts.append(f"arity {len(oa)}->{len(na)}")
    else:
        for i, ((osh, odt), (nsh, ndt)) in enumerate(zip(oa, na)):
            if osh != nsh:
                if len(osh) == len(nsh):
                    dims = ", ".join(f"dim{j} {osh[j]}->{nsh[j]}"
                                     for j in range(len(osh))
                                     if osh[j] != nsh[j])
                    parts.append(f"arg{i} shape {osh}->{nsh} ({dims})")
                else:
                    parts.append(f"arg{i} rank {len(osh)}->{len(nsh)} "
                                 f"({osh}->{nsh})")
            if odt != ndt:
                parts.append(f"arg{i} dtype {odt}->{ndt}")
    if ostatic != nstatic:
        parts.append(f"static args {ostatic or '()'}->{nstatic or '()'}")
    return "; ".join(parts) or "signature changed"


@dataclass
class RetraceEvent:
    """One observed retrace: site ('eager'|'to_static'|'train_step'),
    callable/op name, per-site+name retrace count, and the signature delta
    that triggered it."""
    site: str
    name: str
    count: int            # retraces of this site+name since process start
    window_count: int     # retraces since the last reset_window() (epoch)
    delta: str
    signature: tuple
    ts_ns: int = field(default_factory=time.perf_counter_ns)

    def to_dict(self) -> dict:
        return {"site": self.site, "name": self.name, "count": self.count,
                "window_count": self.window_count, "delta": self.delta,
                "ts_ns": self.ts_ns}


class RetraceWatchdog:
    _SEEN_MAX = 4096  # signatures remembered per (site, name)

    def __init__(self, history: int = 256,
                 warn_threshold: Optional[int] = None):
        self._lock = threading.Lock()
        self._seen: Dict[Tuple[str, str], Set[tuple]] = {}
        self._last: Dict[Tuple[str, str], tuple] = {}
        self._retraces: Dict[Tuple[str, str], int] = {}
        self._window: Dict[Tuple[str, str], int] = {}
        self._warned: Set[Tuple[str, str]] = set()
        self._compiles: Dict[str, Dict[str, float]] = {}
        self.events: "deque[RetraceEvent]" = deque(maxlen=history)
        if warn_threshold is None:
            warn_threshold = env_int("PADDLE_TPU_RETRACE_WARN", 0)
        self.warn_threshold = warn_threshold

    # -- recording -----------------------------------------------------------
    def observe(self, site: str, name: str, arrs: Sequence = (),
                static=None, signature: Optional[tuple] = None,
                count_hit: bool = True) -> Optional[RetraceEvent]:
        """Report one jit-cache lookup. Returns a RetraceEvent iff this is a
        NEW signature for a site+name that already compiled a different one.
        `count_hit=False` suppresses the hit counter for callers (the eager
        dispatch cache) that count their own hits and only report misses."""
        sig = signature if signature is not None else signature_of(arrs, static)
        key = (site, name)
        m_on = metrics_mod.enabled()
        with self._lock:
            seen = self._seen.setdefault(key, set())
            if sig in seen:
                if count_hit and m_on:
                    _M_HITS.inc(site=site)
                return None
            # bound per-site+name memory: a workload with endlessly varying
            # shapes (the exact case the watchdog diagnoses) must not grow
            # this set forever — restart dedup when full (a few subsequent
            # re-sighted signatures count as misses again; acceptable)
            if len(seen) >= self._SEEN_MAX:
                seen.clear()
            seen.add(sig)
            last = self._last.get(key)
            self._last[key] = sig
            if m_on:
                _M_MISSES.inc(site=site)
            if last is None:
                return None  # first compile, nothing to diff
            count = self._retraces[key] = self._retraces.get(key, 0) + 1
            wcount = self._window[key] = self._window.get(key, 0) + 1
            event = RetraceEvent(site=site, name=name, count=count,
                                 window_count=wcount,
                                 delta=describe_delta(last, sig),
                                 signature=sig)
            self.events.append(event)
            warn = (self.warn_threshold > 0
                    and wcount >= self.warn_threshold
                    and key not in self._warned)
            if warn:
                self._warned.add(key)
        if m_on:
            _M_RETRACES.inc(site=site)
        events_mod.emit("retrace", site=site, name=name, count=count,
                        delta=event.delta)
        logger.debug("retrace %s:%s #%d — %s", site, name, event.count,
                     event.delta)
        if warn:
            logger.warning(
                "[paddle_tpu_torch] %s %r retraced %d times in one window "
                "(last delta: %s) — varying shapes/dtypes/static args force "
                "a fresh CUDA-graph capture each time; pad or bucket the "
                "inputs (threshold PADDLE_TPU_RETRACE_WARN=%d)",
                site, name, wcount, event.delta, self.warn_threshold)
        return event

    def record_compile(self, entry: str, seconds: float):
        """One graph capture or kernel build attributed to `entry` (fed by
        profiler/compile_watch.py) — so the watchdog snapshot pairs WHAT
        retraced with what the recaptures actually COST."""
        with self._lock:
            s = self._compiles.setdefault(entry,
                                          {"count": 0, "seconds": 0.0})
            s["count"] += 1
            s["seconds"] += float(seconds)

    # -- reading -------------------------------------------------------------
    def total_retraces(self, site: Optional[str] = None) -> int:
        with self._lock:
            if site is None:
                return sum(self._retraces.values())
            return sum(v for (s, _), v in self._retraces.items()
                       if s == site)

    def counts(self) -> Dict[str, int]:
        """{'site:name': retrace count} for everything that retraced."""
        with self._lock:
            return {f"{s}:{n}": c for (s, n), c in self._retraces.items()}

    def snapshot(self) -> dict:
        with self._lock:
            events = [e.to_dict() for e in self.events]
            compiles = {k: dict(v) for k, v in self._compiles.items()}
        return {"total_retraces": self.total_retraces(),
                "by_site_name": self.counts(), "events": events,
                "compiles": compiles}

    # -- lifecycle -----------------------------------------------------------
    def reset_window(self):
        """Start a new warn window (per epoch, from ThroughputMonitor)."""
        with self._lock:
            self._window.clear()
            self._warned.clear()

    def reset(self):
        """Full reset (tests)."""
        with self._lock:
            self._seen.clear()
            self._last.clear()
            self._retraces.clear()
            self._window.clear()
            self._warned.clear()
            self._compiles.clear()
            self.events.clear()


_watchdog = RetraceWatchdog()


def get_watchdog() -> RetraceWatchdog:
    return _watchdog
