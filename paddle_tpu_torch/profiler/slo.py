"""Sliding-window SLO tracker for the serving plane (a copy of
``paddle_tpu/profiler/slo.py`` on the port's envparse, events and metrics
modules).

It keeps sliding windows of the user-facing serving latencies —

    ttft          time to first token (s)
    tpot          time per output token (s)
    queue_wait    admission-queue wait (s)
    e2e           submit -> done wall time (s)
    handoff_wait  prefill -> decode handoff wait (s; a disaggregated
                  pipeline's signal, which the port does not feed yet)

— computes window p50/p95/p99, and holds them against operator targets.
A target excursion emits exactly ONE `slo_breach` structured event and
then re-arms when the window recovers (state on entry, pop on recovery —
never one event per sample).

Knobs (envparse'd):

    PADDLE_TPU_SLO=0                kill switch (observe/check no-ops)
    PADDLE_TPU_SLO_WINDOW=512       samples kept per signal
    PADDLE_TPU_SLO_MIN_SAMPLES=8    samples required before checking
    PADDLE_TPU_SLO_TTFT_P99_S       p99 TTFT target, seconds
    PADDLE_TPU_SLO_TPOT_P99_S       p99 TPOT target, seconds
    PADDLE_TPU_SLO_QUEUE_P99_S     p99 queue-wait target, seconds
    PADDLE_TPU_SLO_E2E_P99_S        p99 e2e-latency target, seconds
    PADDLE_TPU_SLO_HANDOFF_P99_S    p99 handoff-wait target, seconds

Unset targets are simply not checked — the tracker still serves window
quantiles (``snapshot()``) for whatever signals it observed.
"""
from __future__ import annotations

import threading
import weakref
from collections import deque
from typing import Dict, List, Optional

from ..utils.envparse import env_bool, env_float, env_int
from . import events as _events
from . import metrics as _metrics

__all__ = ["SLOTracker", "SIGNALS", "QUANTILES", "enabled",
           "default_targets", "last_status", "current_snapshot"]

SIGNALS = ("ttft", "tpot", "queue_wait", "e2e", "handoff_wait")
QUANTILES = ("p50", "p95", "p99")

_REG = _metrics.default_registry()
_M_BREACHES = _REG.counter(
    "slo_breaches_total",
    "slo_breach excursions (one per entry, re-armed on recovery), "
    "by model and signal")
_M_BREACHED = _REG.gauge(
    "slo_breached",
    "1 while the signal's window p99 exceeds its target else 0, "
    "by model and signal")
_M_P99 = _REG.gauge(
    "slo_window_p99_seconds",
    "sliding-window p99 of the serving signal, by model and signal")


def enabled() -> bool:
    """Kill switch: PADDLE_TPU_SLO=0 disables observation and checking."""
    return env_bool("PADDLE_TPU_SLO", True)


def default_targets() -> Dict[str, float]:
    """p99 targets from the PADDLE_TPU_SLO_* knobs; unset -> unchecked."""
    out: Dict[str, float] = {}
    pairs = (("ttft", env_float("PADDLE_TPU_SLO_TTFT_P99_S", 0.0)),
             ("tpot", env_float("PADDLE_TPU_SLO_TPOT_P99_S", 0.0)),
             ("queue_wait", env_float("PADDLE_TPU_SLO_QUEUE_P99_S", 0.0)),
             ("e2e", env_float("PADDLE_TPU_SLO_E2E_P99_S", 0.0)),
             ("handoff_wait",
              env_float("PADDLE_TPU_SLO_HANDOFF_P99_S", 0.0)))
    for sig, t in pairs:
        if t > 0:
            out[sig] = t
    return out


def _quantile(sorted_vals: List[float], q: float) -> float:
    """Linear-interpolated quantile of an already-sorted sample list."""
    n = len(sorted_vals)
    if n == 1:
        return sorted_vals[0]
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class SLOTracker:
    """Sliding windows + breach detection for one serving engine.

    `observe()` is the hot-path entry (called per request completion /
    first token); `snapshot()` is the whole view. Breach
    state is per signal: enter -> ONE `slo_breach` event + counter inc,
    leave -> re-arm silently (gauge drops back to 0).
    """

    def __init__(self, model: str = "gpt", *,
                 window: Optional[int] = None,
                 min_samples: Optional[int] = None,
                 targets: Optional[Dict[str, float]] = None):
        self.model = model
        self.window = max(1, env_int("PADDLE_TPU_SLO_WINDOW", 512)
                          if window is None else int(window))
        self.min_samples = max(1, env_int("PADDLE_TPU_SLO_MIN_SAMPLES", 8)
                               if min_samples is None else int(min_samples))
        self.targets = dict(default_targets() if targets is None
                            else targets)
        self._lock = threading.Lock()
        self._windows: Dict[str, deque] = {
            s: deque(maxlen=self.window) for s in SIGNALS}
        #: signal -> breach record while breached; absent = armed
        self._breached: Dict[str, dict] = {}
        self.stats = {"breaches": 0, "recoveries": 0, "observations": 0}
        global _current
        _current = weakref.ref(self)

    # -- observation ---------------------------------------------------------
    def observe(self, signal: str, value: float):
        if not enabled():
            return
        if signal not in self._windows:
            raise ValueError(f"unknown SLO signal {signal!r}; "
                             f"expected one of {SIGNALS}")
        with self._lock:
            self._windows[signal].append(float(value))
            self.stats["observations"] += 1
            self._check_locked(signal)

    def quantiles(self, signal: str) -> dict:
        with self._lock:
            return self._quantiles_locked(signal)

    def _quantiles_locked(self, signal: str) -> dict:
        vals = sorted(self._windows[signal])
        out = {"count": len(vals)}
        if not vals:
            out.update({q: None for q in QUANTILES})
            return out
        out["p50"] = _quantile(vals, 0.50)
        out["p95"] = _quantile(vals, 0.95)
        out["p99"] = _quantile(vals, 0.99)
        return out

    # -- breach detection (one event per excursion, re-arm on recovery) ------
    def _check_locked(self, signal: str):
        target = self.targets.get(signal)
        if target is None:
            return
        qs = self._quantiles_locked(signal)
        if qs["count"] < self.min_samples:
            return
        p99 = qs["p99"]
        if _metrics.enabled():
            _M_P99.set(p99, model=self.model, signal=signal)
        if p99 > target:
            if signal not in self._breached:
                self._breached[signal] = {
                    "signal": signal, "quantile": "p99",
                    "value": p99, "target": target,
                    "window": qs["count"]}
                self.stats["breaches"] += 1
                if _metrics.enabled():
                    _M_BREACHES.inc(model=self.model, signal=signal)
                    _M_BREACHED.set(1, model=self.model, signal=signal)
                _events.emit("slo_breach", severity="warn",
                             model=self.model, signal=signal,
                             quantile="p99", value=p99, target=target,
                             window=qs["count"])
            else:
                # still breached: refresh the live excursion value only
                self._breached[signal]["value"] = p99
        elif signal in self._breached:
            self._breached.pop(signal, None)
            self.stats["recoveries"] += 1
            if _metrics.enabled():
                _M_BREACHED.set(0, model=self.model, signal=signal)

    # -- views ---------------------------------------------------------------
    def breached(self) -> Dict[str, dict]:
        with self._lock:
            return {s: dict(b) for s, b in self._breached.items()}

    def status(self) -> str:
        """'ok' | 'breach:<signal,...>'."""
        with self._lock:
            if not self._breached:
                return "ok"
            return "breach:" + ",".join(sorted(self._breached))

    def snapshot(self) -> dict:
        """Targets, window quantiles per signal, and current breach
        status."""
        with self._lock:
            return {
                "enabled": enabled(),
                "model": self.model,
                "window": self.window,
                "min_samples": self.min_samples,
                "targets": dict(self.targets),
                "signals": {s: self._quantiles_locked(s) for s in SIGNALS},
                "breached": {s: dict(b)
                             for s, b in self._breached.items()},
                "status": ("ok" if not self._breached else
                           "breach:" + ",".join(sorted(self._breached))),
                "stats": dict(self.stats),
            }


#: weakref to the most recently constructed tracker (`last_status`,
#: `current_snapshot`)
_current: Optional["weakref.ref[SLOTracker]"] = None


def _current_tracker() -> Optional[SLOTracker]:
    ref = _current
    return ref() if ref is not None else None


def last_status() -> Optional[str]:
    """Status of the live tracker ('ok' / 'breach:...'), None if no
    serving engine has constructed one."""
    t = _current_tracker()
    return t.status() if t is not None else None


def current_snapshot() -> Optional[dict]:
    t = _current_tracker()
    return t.snapshot() if t is not None else None
