"""Compile attribution: CUDA-graph captures and kernel builds -> entry points
(counterpart of ``paddle_tpu/profiler/compile_watch.py``).

The reference subscribes to ``jax.monitoring`` and attributes every XLA
trace/lower/compile to the entry point that triggered it. The port
"compiles" in two places, and both report here:

* a CUDA-graph capture (``jit.graphs.StepGraphs._capture``, shared by
  ``jit.TrainStep`` and the serving engine), phase ``graph_capture``;
* the first-use ``nvcc`` build of the kernel library
  (``_native.build``), phase ``kernel_build``; the build directory's
  up-to-date library is a cache ``hit``, a rebuild a ``miss``.

Entry points push a thread-local label around the calls that may compile
(``train_step:<layer>`` in ``jit.TrainStep``,
``to_static:serving_prefill:<name>`` and ``to_static:serving_decode:<name>``
in the serving engine, as the reference labels them); what is observed
with no label lands under ``unattributed``.

The families and the ``summary()`` keys are the reference's, so
``/snapshot``'s ``compile_attribution`` reads the same:

* metrics: ``xla_compiles_total{entry=}`` (one per capture or build),
  ``xla_compile_seconds{entry=,phase=}`` histograms (phase:
  ``graph_capture`` / ``kernel_build``), and
  ``xla_compile_cache_events_total{event=}`` (``hit`` / ``miss``);
* the retrace watchdog's snapshot gains a ``compiles`` section (count +
  seconds per entry);
* the unified event log gets one ``xla_compile`` event per capture or
  build.

``summary()`` entries also carry ``phases`` ({phase: {count, seconds}}).

Also owns the relaunch-to-first-step clock: `PROCESS_T0` is captured when
`paddle_tpu_torch.profiler` imports, and `note_first_step()` publishes
`relaunch_to_first_step_seconds{generation=}` once.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict

from . import events as events_mod
from . import metrics as metrics_mod

__all__ = ["install", "installed", "push_entry", "pop_entry",
           "current_entry", "record", "record_cache_event", "summary",
           "reset", "note_first_step", "PROCESS_T0", "PHASES"]

#: monotonic clock at profiler import — the relaunch-to-first-step origin
PROCESS_T0 = time.monotonic()

#: the phases the port reports (the reference's are trace / lower /
#: backend_compile)
PHASES = ("graph_capture", "kernel_build")

_REG = metrics_mod.default_registry()
# capture and build durations span ms (a small graph) to minutes (nvcc)
_COMPILE_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)
_M_COMPILES = _REG.counter(
    "xla_compiles_total",
    "CUDA-graph captures and kernel builds attributed to the entry point "
    "that triggered them (to_static:<fn> / train_step:<layer> / "
    "unattributed)")
_M_COMPILE_SECONDS = _REG.histogram(
    "xla_compile_seconds",
    "capture and build durations by entry point and phase "
    "(graph_capture / kernel_build)", buckets=_COMPILE_BUCKETS)
_M_CACHE_EVENTS = _REG.counter(
    "xla_compile_cache_events_total",
    "kernel build directory events (hit: the library was up to date; "
    "miss: rebuilt)")
_M_FIRST_STEP = _REG.gauge(
    "relaunch_to_first_step_seconds",
    "wall time from process start (profiler import) to the first observed "
    "train step, by elastic generation — the relaunch cold-start cost "
    "(import + restore + kernel build + graph capture)")

_tls = threading.local()
_lock = threading.Lock()
_summary: Dict[str, dict] = {}  # entry -> {count, seconds, phases}
_installed = False
_first_step_noted = False


# -- entry-point labels ------------------------------------------------------
def push_entry(site: str, name: str):
    """Mark the current thread as executing entry `site:name`; returns the
    previous label (pass to pop_entry)."""
    prev = getattr(_tls, "entry", None)
    _tls.entry = (site, name)
    return prev


def pop_entry(prev):
    _tls.entry = prev


def current_entry() -> str:
    e = getattr(_tls, "entry", None)
    return f"{e[0]}:{e[1]}" if e else "unattributed"


# -- the reports -------------------------------------------------------------
def record(phase: str, seconds: float) -> None:
    """One graph capture or kernel build of `seconds`, attributed to the
    current entry."""
    if phase not in PHASES:
        raise ValueError(f"phase {phase!r} is not one of {PHASES}")
    entry = current_entry()
    seconds = float(seconds)
    if metrics_mod.enabled():
        _M_COMPILE_SECONDS.observe(seconds, entry=entry, phase=phase)
        _M_COMPILES.inc(entry=entry)
    with _lock:
        s = _summary.setdefault(entry, {"count": 0, "seconds": 0.0,
                                        "phases": {}})
        s["count"] += 1
        s["seconds"] += seconds
        p = s["phases"].setdefault(phase, {"count": 0, "seconds": 0.0})
        p["count"] += 1
        p["seconds"] += seconds
    # feed the retrace watchdog: its snapshot is THE one-stop retrace view
    from .watchdog import get_watchdog
    get_watchdog().record_compile(entry, seconds)
    events_mod.emit("xla_compile", entry=entry, phase=phase,
                    seconds=round(seconds, 6))


def record_cache_event(event: str) -> None:
    """A kernel build directory ``hit`` (up to date) or ``miss``
    (rebuilt)."""
    if metrics_mod.enabled():
        _M_CACHE_EVENTS.inc(event=event)


def install() -> bool:
    """Idempotent; subscribes to nothing (the reports above are called by
    the capture and the build themselves). Returns True."""
    global _installed
    _installed = True
    return True


def installed() -> bool:
    return _installed


# -- reading -----------------------------------------------------------------
def summary() -> Dict[str, dict]:
    """{entry: {"count": n, "seconds": s, "phases": {phase: {"count",
    "seconds"}}}} of captures and builds so far."""
    with _lock:
        return {k: {"count": v["count"], "seconds": v["seconds"],
                    "phases": {p: dict(d) for p, d in v["phases"].items()}}
                for k, v in _summary.items()}


def reset():
    """Tests only: zero the attribution summary."""
    global _first_step_noted
    with _lock:
        _summary.clear()
    _first_step_noted = False


# -- relaunch-to-first-step --------------------------------------------------
def note_first_step():
    """Publish the relaunch-to-first-step gauge once per process; called by
    the liveness tracker on the first observed step."""
    global _first_step_noted
    if _first_step_noted:
        return
    _first_step_noted = True
    if metrics_mod.enabled():
        gen = os.environ.get("PADDLE_TPU_ELASTIC_RESTART_NUM", "0")
        _M_FIRST_STEP.set(time.monotonic() - PROCESS_T0, generation=gen)
