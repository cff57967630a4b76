"""RecordEvent + result loading (counterpart of ``paddle_tpu/profiler/
utils.py``).

Reference parity: `python/paddle/profiler/utils.py:31` (RecordEvent
ContextDecorator), `:125` (load_profiler_result), `:153` (wrap_optimizers).
Each span is recorded to the host recorder AND, while a device trace
records (a GPU ``Profiler`` window or a ``/profile`` capture, see
:func:`xplane.annotating`), opened as a ``torch.profiler.record_function``
range: Kineto writes it as a ``user_annotation`` on the host lane and
projects it onto the CUDA streams its launches ran on
(``gpu_user_annotation``), which is what ``xplane.correlate`` reads.
"""
from __future__ import annotations

import json
import threading
from contextlib import ContextDecorator

import torch

from . import xplane as _xplane
from .recorder import HostSpan, get_recorder, now_ns


class TracerEventType:
    Operator = "Operator"
    Dataloader = "Dataloader"
    ProfileStep = "ProfileStep"
    UserDefined = "UserDefined"
    Forward = "Forward"
    Backward = "Backward"
    Optimization = "Optimization"
    Communication = "Communication"


class RecordEvent(ContextDecorator):
    """RAII profiling span (reference `utils.py:31` / C++ `RecordEvent`)."""

    def __init__(self, name: str, event_type: str = TracerEventType.UserDefined):
        self.name = name
        self.event_type = event_type
        self._start = None
        self._range = None
        self._pushed = False

    def begin(self):
        rec = get_recorder()
        self._start = now_ns()
        if rec.enabled:
            rec.span_stack().append(self.name)
            self._pushed = True
            if _xplane.annotating():
                self._range = torch.profiler.record_function(self.name)
                self._range.__enter__()

    def end(self):
        if self._start is None:
            return
        rec = get_recorder()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        # pop even if the record window closed mid-span, else the thread's
        # stack leaks the entry and later spans get a stale parent
        if self._pushed:
            stack = rec.span_stack()
            if self.name in stack:
                stack.reverse()
                stack.remove(self.name)
                stack.reverse()
            self._pushed = False
        if rec.enabled:
            stack = rec.span_stack()
            parent = stack[-1] if stack else None
            rec.push(HostSpan(name=self.name, start_ns=self._start,
                              end_ns=now_ns(), tid=threading.get_ident(),
                              event_type=self.event_type, parent=parent))
        self._start = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def load_profiler_result(filename: str):
    """Load a chrome-trace JSON exported by Profiler.export (`utils.py:125`)."""
    with open(filename) as f:
        return json.load(f)


def wrap_optimizers():
    """No-op for parity: optimizer.step is already spanned via RecordEvent in
    Profiler-enabled training loops (reference monkey-patches optimizers)."""
    return None
