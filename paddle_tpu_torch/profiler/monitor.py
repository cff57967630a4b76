"""Step-level training monitor: windowed throughput / data-wait / MFU /
retrace reporting as JSONL (counterpart of ``paddle_tpu/profiler/
monitor.py``; the record schema is the reference's).

`ThroughputMonitor` is a hapi-compatible callback (duck-typed against
`hapi.callbacks.Callback` so this module stays import-cycle-free) that
combines the `timer.Benchmark` ips machinery with cost-model FLOPs and the
retrace watchdog into ONE record per step window:

    {"ts": 1722700000.0, "step": 40, "window_steps": 20,
     "step_time_ms": 12.5, "steps_per_sec": 80.0, "ips": 10240.0,
     "samples": 2560, "data_wait_frac": 0.03,
     "flops_per_step_est": 1.2e12, "mfu_est": 0.31, "retraces": 0}

`validate_step_record` is the schema contract tests and tools check
against. The MFU denominator defaults to the card's peak
(`device_time.GPU_PEAK_FLOPS`, 989e12 bf16 dense on an H100;
`BENCH_PEAK_FLOPS` overrides it).

`diagnose_window` reads the reference's families. Those the port does not
feed read 0: `op_time_seconds` and `op_device_seconds` (the port has no
per-op dispatch layer), `collective_seconds` (the collectives are ROADMAP
A11), `ckpt_barrier_wait_seconds` (the coordinated checkpoint is A11's);
`compile` reads the graph captures and kernel builds of
`compile_watch`.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, List, Optional

from . import device_time as _device_time
from . import metrics as metrics_mod
from . import server as server_mod
from .timer import benchmark
from .watchdog import get_watchdog

__all__ = ["ThroughputMonitor", "make_step_record", "validate_step_record",
           "STEP_RECORD_REQUIRED", "STEP_RECORD_FIELDS",
           "diag_signals", "diagnose_window", "DIAG_TERMS"]

# schema: required keys are always present; optional keys are present but
# may be null when the ingredient (sample counts, FLOPs) is unknown
STEP_RECORD_REQUIRED = {
    "ts": float, "step": int, "window_steps": int, "step_time_ms": float,
    "steps_per_sec": float, "data_wait_frac": float, "retraces": int,
}
STEP_RECORD_OPTIONAL = {
    "ips": float, "samples": int, "flops_per_step_est": float,
    "mfu_est": float, "device_mem_bytes": int, "device_mem_peak_bytes": int,
}
STEP_RECORD_FIELDS = set(STEP_RECORD_REQUIRED) | set(STEP_RECORD_OPTIONAL)

_DEFAULT_PEAK_FLOPS = float(os.environ.get("BENCH_PEAK_FLOPS",
                                          _device_time.GPU_PEAK_FLOPS))


def make_step_record(*, step: int, window_steps: int, window_time_s: float,
                     samples: Optional[int] = None,
                     data_wait_s: float = 0.0,
                     flops_per_step: Optional[float] = None,
                     peak_flops: Optional[float] = None,
                     retraces: int = 0,
                     device_mem_bytes: Optional[int] = None,
                     device_mem_peak_bytes: Optional[int] = None) -> dict:
    """Build one schema-conformant step-window record. Degrades gracefully:
    a zero-length window yields zero rates, missing samples/FLOPs yield
    null ips/mfu — never a ZeroDivisionError."""
    window_steps = max(int(window_steps), 0)
    steps_per_sec = window_steps / window_time_s if window_time_s > 0 else 0.0
    ips = (float(samples) / window_time_s
           if samples and window_time_s > 0 else None)
    peak = peak_flops if peak_flops else _DEFAULT_PEAK_FLOPS
    mfu = (float(flops_per_step) * steps_per_sec / peak
           if flops_per_step and steps_per_sec > 0 and peak > 0 else None)
    return {
        "ts": time.time(),
        "step": int(step),
        "window_steps": window_steps,
        "step_time_ms": (1000.0 * window_time_s / window_steps
                         if window_steps else 0.0),
        "steps_per_sec": steps_per_sec,
        "ips": ips,
        "samples": int(samples) if samples else None,
        "data_wait_frac": (min(1.0, max(0.0, data_wait_s / window_time_s))
                           if window_time_s > 0 else 0.0),
        "flops_per_step_est": (float(flops_per_step)
                               if flops_per_step else None),
        "mfu_est": mfu,
        "retraces": int(retraces),
        "device_mem_bytes": (int(device_mem_bytes)
                             if device_mem_bytes is not None else None),
        "device_mem_peak_bytes": (int(device_mem_peak_bytes)
                                  if device_mem_peak_bytes is not None
                                  else None),
    }


def _sampled_device_mem():
    """(bytes_in_use summed, peak summed) across cards, or (None, None)
    when sampling found nothing (metrics disabled, no card). One sampling
    pass refreshes ALL the gauges too."""
    mem = metrics_mod.update_device_memory_gauges()
    if not mem:
        return None, None
    return (sum(v["bytes_in_use"] for v in mem.values()),
            sum(v["peak_bytes"] for v in mem.values()))


# ---------------------------------------------------------------------------
# step-slowness diagnosis: decompose a window's wall time into the runtime's
# known cost terms from signals the registry already holds
# ---------------------------------------------------------------------------
#: the decomposition terms, each backed by named registry families (plus the
#: residual "unattributed" bucket diagnose_window adds)
DIAG_TERMS = ("data_wait", "host_dispatch", "device_compute", "collective",
              "compile", "checkpoint", "straggler_wait")

# term -> metric families whose cumulative seconds feed it (histogram sums
# and counters both work — _cum_seconds handles either)
_DIAG_FAMILIES = {
    "host_dispatch": ("op_time_seconds",),
    "device_compute": ("op_device_seconds",),
    "collective": ("collective_seconds",),
    "compile": ("xla_compile_seconds",),
    "checkpoint": ("checkpoint_save_seconds", "checkpoint_async_seconds"),
    "straggler_wait": ("ckpt_barrier_wait_seconds",),
}


def _cum_seconds(name: str) -> float:
    """Cumulative seconds accumulated by a family across all its series."""
    m = metrics_mod.default_registry().get(name)
    if m is None:
        return 0.0
    try:
        total = 0.0
        for v in m.snapshot()["values"]:
            total += float(v["sum"] if "sum" in v else v.get("value", 0.0))
        return total
    except Exception:
        return 0.0


#: newest diagnosis this process produced (any source: monitor window,
#: capture session, manual call) — the fleet digest picks it up so the
#: aggregator can show every host's dominant term
_last_diagnosis: Optional[dict] = None


def last_diagnosis() -> Optional[dict]:
    return _last_diagnosis


def diag_signals() -> dict:
    """Cumulative per-term seconds right now — capture once at a window's
    start and hand to :func:`diagnose_window` at its end."""
    sig = {}
    for term, fams in _DIAG_FAMILIES.items():
        sig[term] = sum(_cum_seconds(f) for f in fams)
    try:
        sig["data_wait"] = float(benchmark().reader.total_time)
    except Exception:
        sig["data_wait"] = 0.0
    return sig


def diagnose_window(begin: dict, wall_s: float, steps: int = 0,
                    step: Optional[int] = None, emit: bool = True) -> dict:
    """Decompose the window since ``begin`` (a :func:`diag_signals`
    snapshot) and name the dominant cost term.

    Terms are independent cumulative clocks, so they can overlap (device
    compute under async dispatch runs concurrently with host time) and a
    term's share is reported against the wall, clipped to [0, 1] — this is
    a ranking heuristic for "what should I look at first", not an exact
    accounting. Whatever the terms don't cover is ``unattributed`` (python/
    framework host time outside any instrumented clock). Emits one
    ``step_diagnosis`` event naming the dominant term unless ``emit`` is
    False."""
    end = diag_signals()
    terms = {t: max(0.0, end.get(t, 0.0) - begin.get(t, 0.0))
             for t in ("data_wait",) + tuple(_DIAG_FAMILIES)}
    accounted = sum(terms.values())
    wall_s = max(0.0, float(wall_s))
    terms["unattributed"] = max(0.0, wall_s - accounted)
    dominant = max(terms, key=terms.get) if wall_s > 0 else "unknown"
    dom_s = terms.get(dominant, 0.0)
    rec = {
        "wall_s": round(wall_s, 6),
        "steps": int(steps),
        "terms": {t: round(v, 6) for t, v in terms.items()},
        "dominant": dominant,
        "dominant_frac": (round(min(1.0, dom_s / wall_s), 4)
                          if wall_s > 0 else None),
    }
    if step is not None:
        rec["step"] = int(step)
    global _last_diagnosis
    _last_diagnosis = rec
    if emit:
        from . import events as events_mod
        events_mod.emit("step_diagnosis", **rec)
    return rec


def validate_step_record(rec: dict) -> dict:
    """Raise ValueError (naming every violation) unless `rec` conforms to
    the step-JSONL schema; returns the record for chaining."""
    problems = []
    if not isinstance(rec, dict):
        raise ValueError(f"step record must be a dict, got {type(rec)}")
    for key, ty in STEP_RECORD_REQUIRED.items():
        if key not in rec:
            problems.append(f"missing required key {key!r}")
        elif not isinstance(rec[key], (int, float)) or isinstance(rec[key], bool):
            problems.append(f"{key!r} must be numeric, got {type(rec[key])}")
    for key in STEP_RECORD_OPTIONAL:
        if key in rec and rec[key] is not None and (
                not isinstance(rec[key], (int, float))
                or isinstance(rec[key], bool)):
            problems.append(f"{key!r} must be numeric or null, "
                            f"got {type(rec[key])}")
    unknown = set(rec) - STEP_RECORD_FIELDS
    if unknown:
        problems.append(f"unknown keys {sorted(unknown)}")
    if not problems:
        if rec.get("window_steps", 0) < 0:
            problems.append("window_steps < 0")
        dwf = rec.get("data_wait_frac", 0.0)
        if not (0.0 <= dwf <= 1.0):
            problems.append(f"data_wait_frac {dwf} outside [0, 1]")
    if problems:
        raise ValueError("invalid step record: " + "; ".join(problems))
    return rec


class ThroughputMonitor:
    """hapi callback emitting one JSONL record per `window` train steps.

    Usage (hapi):
        model.fit(..., callbacks=[ThroughputMonitor(
            window=50, jsonl_path="steps.jsonl",
            flops_per_sample=3 * 4.09e9, samples_per_step=batch_size)])

    Or drive the hooks manually from a custom loop (`on_train_begin`, then
    `on_train_batch_begin`/`on_train_batch_end` per step, `on_train_end`).

    Data-wait time comes from the global `timer.benchmark()` reader
    averager, which the DataLoader iterators feed; retrace counts from the
    watchdog (whose warn window resets per epoch here — that is what turns
    `PADDLE_TPU_RETRACE_WARN` into "op X retraced N times in one epoch").
    """

    def __init__(self, window: int = 20, jsonl_path: Optional[str] = None,
                 flops_per_sample: Optional[float] = None,
                 flops_per_step: Optional[float] = None,
                 samples_per_step: Optional[int] = None,
                 peak_flops: Optional[float] = None,
                 emit: Optional[Callable[[dict], None]] = None,
                 diagnose: bool = True):
        self.window = max(int(window), 1)
        self.jsonl_path = jsonl_path
        self.flops_per_sample = flops_per_sample
        self.flops_per_step = flops_per_step
        self.samples_per_step = samples_per_step
        self.peak_flops = peak_flops or _DEFAULT_PEAK_FLOPS
        self.records: List[dict] = []
        self.diagnose = bool(diagnose)
        self.diagnoses: List[dict] = []
        self._emit = emit
        self._file = None
        self.model = None
        self.params = {}
        self._reset_window_state()
        self._global_step = 0

    # hapi Callback protocol (duck-typed, no base-class import)
    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def _reset_window_state(self):
        self._win_t0 = None
        self._win_steps = 0
        self._win_samples = 0
        self._reader_t0 = 0.0
        self._retrace_t0 = 0
        self._diag0 = None

    # -- hooks ---------------------------------------------------------------
    def on_train_begin(self, logs=None):
        self._global_step = 0
        self._reset_window_state()
        if self.jsonl_path and self._file is None:
            self._file = open(self.jsonl_path, "a")

    def on_epoch_begin(self, epoch, logs=None):
        get_watchdog().reset_window()

    def on_train_batch_begin(self, step, logs=None):
        if self._win_t0 is None:
            self._win_t0 = time.perf_counter()
            self._reader_t0 = benchmark().reader.total_time
            self._retrace_t0 = get_watchdog().total_retraces()
            if self.diagnose:
                self._diag0 = diag_signals()

    def on_train_batch_end(self, step, logs=None):
        self._global_step += 1
        if self.model is None:
            # manually-driven loop (no hapi fit, which notes its own
            # global step): feed /healthz liveness + the fleet digest here
            server_mod.note_step(self._global_step)
        self._win_steps += 1
        n = self.samples_per_step
        if n is None and isinstance(logs, dict):
            n = logs.get("num_samples")
        if n:
            self._win_samples += int(n)
        if self._win_steps >= self.window:
            self._flush_window()

    def on_epoch_end(self, epoch, logs=None):
        self._flush_window()

    def on_train_end(self, logs=None):
        self._flush_window()
        if self._file is not None:
            self._file.close()
            self._file = None

    # unused hooks (hapi CallbackList calls them all)
    def on_eval_begin(self, logs=None): pass
    def on_eval_end(self, logs=None): pass
    def on_predict_begin(self, logs=None): pass
    def on_predict_end(self, logs=None): pass
    def on_eval_batch_begin(self, step, logs=None): pass
    def on_eval_batch_end(self, step, logs=None): pass
    def on_predict_batch_begin(self, step, logs=None): pass
    def on_predict_batch_end(self, step, logs=None): pass

    # -- emission ------------------------------------------------------------
    def _flush_window(self):
        if self._win_t0 is None or self._win_steps == 0:
            self._reset_window_state()
            return
        dt = time.perf_counter() - self._win_t0
        flops = self.flops_per_step
        if flops is None and self.flops_per_sample and self._win_steps:
            flops = (self.flops_per_sample * self._win_samples
                     / self._win_steps) if self._win_samples else None
        mem_bytes, mem_peak = _sampled_device_mem()
        rec = make_step_record(
            step=self._global_step,
            window_steps=self._win_steps,
            window_time_s=dt,
            samples=self._win_samples or None,
            data_wait_s=max(0.0, benchmark().reader.total_time
                            - self._reader_t0),
            flops_per_step=flops,
            peak_flops=self.peak_flops,
            retraces=get_watchdog().total_retraces() - self._retrace_t0,
            device_mem_bytes=mem_bytes,
            device_mem_peak_bytes=mem_peak)
        self.records.append(rec)
        if self.diagnose and self._diag0 is not None:
            self.diagnoses.append(diagnose_window(
                self._diag0, dt, steps=self._win_steps,
                step=self._global_step))
        line = json.dumps(rec)
        if self._file is not None:
            self._file.write(line + "\n")
            self._file.flush()
        if self._emit is not None:
            self._emit(rec)
        self._reset_window_state()
