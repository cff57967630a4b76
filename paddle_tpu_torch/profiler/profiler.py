"""Profiler with step-window scheduling and chrome-trace export
(counterpart of ``paddle_tpu/profiler/profiler.py``).

Reference parity: `python/paddle/profiler/profiler.py` — `Profiler:262`
(start/stop/step/export/summary, context manager), `make_scheduler:65`
(closed→ready→record windows with repeat/skip_first),
`export_chrome_tracing:152` / `export_protobuf:203` (on_trace_ready
callables). Device-side: when the GPU target is profiled and `trace_dir`
is set, each record window runs a ``torch.profiler.profile`` over the CPU
and CUDA activities (Kineto over CUPTI, in place of the reference's
``jax.profiler``), exports Kineto's chrome trace into `trace_dir`, and
correlates it onto the window's host spans (``xplane_stats``). A READY
step before a window starts that profiler a step early, as a lead-in.

The default targets are [CPU, GPU], and follow the port's device rule:
asking for GPU on a machine without a card raises (pass
``targets=[ProfilerTarget.CPU]`` there); ``ProfilerTarget.TPU`` raises.
"""
from __future__ import annotations

import json
import os
import socket
import time
from enum import Enum
from typing import Callable, Iterable, Optional

import torch

from . import xplane as _xplane
from .recorder import get_recorder
from .statistic import SortedKeys, StatisticData, summary_report


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1      # the CUDA card, traced by Kineto
    TPU = 2      # the reference's; refused here
    CUSTOM_DEVICE = 3


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """Step-window state machine (reference `profiler.py:65`)."""
    num_steps = closed + ready + record

    def scheduler(step: int) -> ProfilerState:
        assert step >= 0
        if step < skip_first:
            return ProfilerState.CLOSED
        step -= skip_first
        period = step // num_steps
        if repeat and period >= repeat:
            return ProfilerState.CLOSED
        pos = step % num_steps
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos < num_steps - 1:
            return ProfilerState.RECORD
        return ProfilerState.RECORD_AND_RETURN
    return scheduler


def _default_state_scheduler(step: int):
    return ProfilerState.RECORD


def export_chrome_tracing(dir_name: str,
                          worker_name: Optional[str] = None) -> Callable:
    """on_trace_ready callable writing chrome://tracing JSON
    (reference `profiler.py:152`)."""
    os.makedirs(dir_name, exist_ok=True)

    def handler(prof: "Profiler"):
        name = worker_name or f"host_{socket.gethostname()}_pid_{os.getpid()}"
        path = os.path.join(dir_name, f"{name}_time_{time.time_ns()}"
                                      f".paddle_trace.json")
        prof.export(path, format="json")
        return path
    return handler


def export_protobuf(dir_name: str,
                    worker_name: Optional[str] = None) -> Callable:
    """Parity alias — exports the same JSON payload with .pb.json suffix (we
    have no profiler.proto; the chrome JSON is the interchange format)."""
    os.makedirs(dir_name, exist_ok=True)

    def handler(prof: "Profiler"):
        name = worker_name or f"host_{socket.gethostname()}_pid_{os.getpid()}"
        path = os.path.join(dir_name, f"{name}_time_{time.time_ns()}"
                                      f".pb.json")
        prof.export(path, format="json")
        return path
    return handler


def _get_supported_targets() -> Iterable[ProfilerTarget]:
    return [ProfilerTarget.CPU, ProfilerTarget.GPU]


def _check_targets(targets):
    for t in targets:
        if t in (ProfilerTarget.TPU, ProfilerTarget.CUSTOM_DEVICE):
            raise ValueError(f"Profiler: target {t.name} is not supported "
                             f"by the port (CPU and GPU are)")
        if t is ProfilerTarget.GPU and not torch.cuda.is_available():
            raise RuntimeError(
                "Profiler: target GPU asked for, but no CUDA card is "
                "available; pass targets=[ProfilerTarget.CPU] to profile "
                "the host alone")


class Profiler:
    """Reference `profiler.py:262`.

    Usage:
        with Profiler(scheduler=(2, 5)) as p:
            for batch in loader:
                train_step(batch)
                p.step()
        p.summary()
    """

    def __init__(self, *, targets: Optional[Iterable[ProfilerTarget]] = None,
                 scheduler=None, on_trace_ready: Optional[Callable] = None,
                 timer_only: bool = False, trace_dir: Optional[str] = None):
        self.targets = list(targets) if targets is not None \
            else list(_get_supported_targets())
        _check_targets(self.targets)
        if scheduler is None:
            self._scheduler = _default_state_scheduler
        elif isinstance(scheduler, (tuple, list)):
            start, end = scheduler
            self._scheduler = make_scheduler(closed=max(start - 1, 0),
                                             ready=min(start, 1),
                                             record=end - start, repeat=1)
        else:
            self._scheduler = scheduler
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.trace_dir = trace_dir
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self._spans = []
        self._device_trace = None  # the window's torch profiler
        self.trace_path: Optional[str] = None  # the last window's Kineto trace
        self.xplane_stats = None  # correlation stats of the last window
        from .timer import benchmark
        self._benchmark = benchmark()

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        self._benchmark.begin()
        if self.timer_only:
            return
        self.current_state = self._scheduler(self.step_num)
        if self.current_state in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN):
            self._start_record()
        elif self.current_state is ProfilerState.READY:
            self._start_device_trace()

    def stop(self):
        self._benchmark.end()
        if self.timer_only:
            return
        if self.current_state in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN):
            self._stop_record()
            if self.on_trace_ready:
                self.on_trace_ready(self)
        else:
            self._drop_device_trace()  # a lead-in that never recorded

    def step(self, num_samples: Optional[int] = None):
        self._benchmark.step(num_samples)
        if self.timer_only:
            self.step_num += 1
            return
        prev = self.current_state
        self.step_num += 1
        self.current_state = self._scheduler(self.step_num)
        recording = (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
        # RECORD_AND_RETURN always closes its window (even into a back-to-back
        # next window), so every window's trace is exported
        if prev == ProfilerState.RECORD_AND_RETURN:
            self._stop_record()
            if self.on_trace_ready:
                self.on_trace_ready(self)
            if self.current_state in recording:
                self._start_record()
        elif prev not in recording and self.current_state in recording:
            self._start_record()
        elif prev in recording and self.current_state not in recording:
            self._stop_record()
        if self.current_state is ProfilerState.READY:
            self._start_device_trace()
        elif self.current_state is ProfilerState.CLOSED:
            self._drop_device_trace()

    def step_info(self, unit: str = "samples") -> str:
        return self._benchmark.step_info(unit)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- recording ----------------------------------------------------------
    def _start_device_trace(self):
        """Start the window's torch profiler (GPU target and `trace_dir`)
        once: at a READY step, which then is the window's lead-in (Kineto
        drops the GPU records it stamps before a window's start, and in a
        long-lived process its GPU clock runs ahead of the host's; see
        `xplane.ProfileCapture`), else at the window's first RECORD step.
        A profiler that cannot start on the card raises."""
        if self._device_trace is None and self.trace_dir and \
                ProfilerTarget.GPU in self.targets:
            self._device_trace = _xplane.start_trace()

    def _drop_device_trace(self):
        """Stop a lead-in's torch profiler that no window recorded into."""
        if self._device_trace is not None:
            prof, self._device_trace = self._device_trace, None
            prof.stop()

    def _start_record(self):
        rec = get_recorder()
        rec.clear()
        rec.enabled = True
        self._start_device_trace()
        if self._device_trace is not None:
            # RecordEvent opens record_function ranges while it records, so
            # the correlation below can hand device time back per span
            _xplane._ANNOTATING = True

    def _stop_record(self):
        rec = get_recorder()
        rec.enabled = False
        self._spans = rec.collect()
        if self._device_trace is not None:
            _xplane._ANNOTATING = False
            prof, self._device_trace = self._device_trace, None
            self.trace_path = _xplane.stop_trace(
                prof, self.trace_dir,
                f"window_{self.step_num}_{time.time_ns()}.pt.trace.json")
            # upgrade span device time from the trace just written
            # (device_src="xplane" in summary/export); the roofline
            # estimates survive when the parse finds nothing
            try:
                doc = _xplane.load_trace(self.trace_path)
                self.xplane_stats = _xplane.correlate(
                    self._spans, doc.get("traceEvents", []))
            except (OSError, ValueError):
                self.xplane_stats = None

    # -- results ------------------------------------------------------------
    def export(self, path: str, format: str = "json"):
        """Write collected host spans as chrome://tracing JSON."""
        events = []
        pid = os.getpid()
        for s in self._spans:
            args = dict(s.args) if s.args else {}
            if s.parent:
                args["parent"] = s.parent
            if s.device_ns is not None:
                # host dispatch vs device execution split (device_time.py);
                # src says whether it was measured (sync mode) or a
                # roofline estimate
                args["device_us"] = s.device_ns / 1e3
                args["device_src"] = s.device_src
            events.append({
                "name": s.name, "ph": "X", "cat": s.event_type,
                "ts": s.start_ns / 1e3, "dur": s.dur_ns / 1e3,
                "pid": pid, "tid": s.tid,
                "args": args,
            })
        payload = {"traceEvents": events,
                   "displayTimeUnit": "ms",
                   "metadata": {"producer": "paddle_tpu_torch.profiler"}}
        with open(path, "w") as f:
            json.dump(payload, f)
        return path

    def statistic_data(self) -> StatisticData:
        return StatisticData(self._spans)

    def summary(self, sorted_by: SortedKeys = None, op_detail: bool = True,
                thread_sep: bool = False, time_unit: str = 'ms') -> str:
        report = summary_report(self.statistic_data(),
                                sorted_by=sorted_by, time_unit=time_unit)
        print(report)
        return report
