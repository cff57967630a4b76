"""Measured device time from a ``torch.profiler`` (Kineto) trace: the
counterpart of ``paddle_tpu/profiler/xplane.py``, kept under its name so
that a reader finds it. The trace here is Kineto's chrome export (over
CUPTI), not XPlane; the label ``device_src="xplane"`` is kept all the
same, because tools read it: in both packages it means "measured from the
device trace".

Device-time attribution by roofline ESTIMATE (or wall-until-completion
under ``PADDLE_TPU_DEVICE_TIME=sync``) lives in ``device_time.py``. This
module adds the authoritative mode: run a bounded ``torch.profiler``
session, parse the chrome trace it exports (``export_chrome_trace``;
stdlib ``json``/``gzip``), and correlate the card's work events back to
host spans — ``HostSpan.device_ns`` gains ``device_src="xplane"``.

Kineto's event model:

* **work events** are the ``cat`` values ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset``, on the GPU stream lanes (``pid`` the card, ``tid`` the
  stream). The kernels of a CUDA-graph replay are traced one by one.
* **annotations**: a ``torch.profiler.record_function`` range (what
  ``RecordEvent`` opens while a trace records, see :func:`annotating`) is
  a ``user_annotation`` on its host thread's lane, and Kineto projects it
  onto every stream its launches ran on as a ``gpu_user_annotation``
  carrying the same ``External id``.

Correlation: the k-th ``user_annotation`` named N is matched to the k-th
collected host span named N, aligned from the newest (spans recorded
before the trace started have no annotation). A span's device time is the
summed overlap of the work events with its ``gpu_user_annotation``
windows, each on its own stream (the host window when Kineto projected
none). A replayed graph's kernels run under the annotation in which the
replay was launched, so a captured training or decode step yields one
measured span per step — which is why :class:`ProfileCapture` brackets
every observed train step in a synthesized ``train_step`` span.

On-demand capture: :class:`ProfileCapture` arms a bounded window around
the next N observed train steps (``server.note_step`` drives it), with a
hard wall-clock cap so a stalled job cannot trace forever — the
``/profile?steps=N`` endpoint on the ObservabilityServer fronts it. The
torch profiler is started and stopped on the thread that calls
``note_step`` (the training thread): its state is that thread's. When
the cap's timer finalizes a window, the summary is built at once from the
host spans, and the device trace stops at the training thread's next
step (the next ``arm`` drops it if that thread has ended).
"""
from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..utils.envparse import env_float
from . import device_time as _device_time
from . import events as _events_mod
from . import metrics as _metrics_mod
from .recorder import HostSpan, get_recorder, now_ns

__all__ = [
    "CaptureBusyError", "CaptureSession", "ProfileCapture",
    "default_capture", "annotating", "find_trace_file", "load_trace",
    "classify_lanes", "work_events", "segment_breakdown", "correlate",
    "capture_timeout", "start_trace", "stop_trace", "WORK_CATS",
]

#: default hard wall-clock cap (seconds) on one capture session
DEFAULT_CAPTURE_TIMEOUT = 120.0
#: Kineto's categories of work on the card
WORK_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: a record_function range on its host lane, and its projection on a stream
HOST_ANNOTATION = "user_annotation"
GPU_ANNOTATION = "gpu_user_annotation"
#: the file a session's trace is exported to
TRACE_FILE = "kineto.pt.trace.json"
#: steps between a capture's trace start and its first step span
#: (ProfileCapture's docstring says why)
LEAD_IN_STEPS = 1

_REG = _metrics_mod.default_registry()
_M_CAPTURES = _REG.counter(
    "profile_captures_total",
    "on-demand profiler capture sessions by terminal status "
    "(complete / timeout / error)")

# True while a device trace records: RecordEvent then opens a
# record_function range, so its name lands in the trace for correlation
_ANNOTATING = False


def annotating() -> bool:
    """Cheap flag: open record_function ranges for RecordEvent spans?"""
    return _ANNOTATING


class CaptureBusyError(RuntimeError):
    """A capture session is already armed/recording (one at a time), or
    the host recorder is owned by an active Profiler window."""


# ---------------------------------------------------------------------------
# the torch profiler
# ---------------------------------------------------------------------------
def start_trace():
    """Start a torch profiler on this thread: the CPU activity, and CUDA's
    where a card is present. Raises when it cannot start."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    # one cycle: acc_events keeps torch from warning that cycles clear
    prof = profile(activities=acts, acc_events=True)
    prof.start()
    return prof


def stop_trace(prof, trace_dir: str, name: str = TRACE_FILE) -> str:
    """Stop `prof` (on the thread that started it) and export its chrome
    trace into `trace_dir`; returns the file's path."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()  # the last launches' work lands in it
    prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, name)
    prof.export_chrome_trace(path)
    return path


# ---------------------------------------------------------------------------
# trace parsing
# ---------------------------------------------------------------------------
def find_trace_file(session_dir: str) -> Optional[str]:
    """Newest Kineto chrome trace (``*.pt.trace.json``, ``*.trace.json``,
    gzipped or not) in `session_dir`."""
    hits: List[str] = []
    for pat in ("*.trace.json", "*.trace.json.gz"):
        hits.extend(glob.glob(os.path.join(session_dir, pat)))
    return max(hits, key=os.path.getmtime) if hits else None


def load_trace(path: str) -> dict:
    """A chrome-trace dict from ``.json.gz`` / plain ``.json``."""
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return json.load(f)
    with open(path) as f:
        return json.load(f)


def _lane(e: dict) -> Tuple[object, object]:
    return (e.get("pid"), e.get("tid"))


def _ext_id(e: dict):
    args = e.get("args")
    if not isinstance(args, dict):
        return None
    return args.get("External id", args.get("external id"))


def classify_lanes(events: Sequence[dict],
                   span_names: Sequence[str] = ()):
    """Split the trace's (pid, tid) lanes into host vs work. Work lanes:
    the CUDA streams, every lane with a work event or a
    ``gpu_user_annotation``. Host lanes: every other lane with a complete
    event (CPU threads: ``user_annotation``, ``cpu_op``, ``cuda_runtime``).
    `span_names` is accepted for the reference's signature. Returns
    (host_lanes, work_lanes) as sets of (pid, tid)."""
    work: set = set()
    seen: set = set()
    for e in events:
        if e.get("ph") != "X":
            continue
        lane = _lane(e)
        seen.add(lane)
        if e.get("cat") in WORK_CATS or e.get("cat") == GPU_ANNOTATION:
            work.add(lane)
    return seen - work, work


def work_events(events: Sequence[dict],
                span_names: Sequence[str] = (),
                lanes=None) -> List[dict]:
    """The card's work events (kernels, copies, sets), ts-sorted. `lanes`
    accepts a precomputed `classify_lanes` result (the reference's
    signature)."""
    _, work = lanes if lanes is not None \
        else classify_lanes(events, span_names)
    out = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in WORK_CATS
           and _lane(e) in work]
    out.sort(key=lambda e: e.get("ts", 0.0))
    return out


# kernel-name segment tags of the port's paths (matched as substrings of
# the lowered name, first match wins): the hand-written kernels by their
# symbols, cuBLAS's GEMMs, the optimizer's multi-tensor kernels
SEGMENT_TAGS = (
    ("attention", ("flash_", "paged_attn", "attention", "fmha")),
    ("ln", ("layer_norm",)),
    ("loss", ("ce_fwd_", "ce_bwd_", "softmax_ce", "cross_entropy",
              "nll_loss", "log_softmax")),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("optimizer", ("multi_tensor_apply",)),
    ("copy", ("memcpy", "memset")),
)

# the backward kernels' names hold one of these
_BWD_MARKERS = ("bwd", "backward")


def segment_breakdown(events: Sequence[dict], lanes=None,
                      tags=SEGMENT_TAGS) -> dict:
    """Measured per-segment device time from a parsed trace.

    Classifies every work event by its kernel name (the reference reads
    the named scopes XLA carries in op metadata; a CUDA kernel carries
    only its symbol), splitting attention further into fwd vs bwd by the
    name. Events no tag matches land in ``unattributed`` (elementwise and
    reduction kernels). Returns ``{"segments": {name: {"device_ms",
    "events", "frac"}}, "total_device_ms", "attributed_frac"}`` sorted by
    time."""
    works = work_events(events, lanes=lanes)
    total_us = 0.0
    seg_us: Dict[str, float] = {}
    seg_n: Dict[str, int] = {}
    for e in works:
        dur = float(e.get("dur", 0.0))
        if dur <= 0:
            continue
        total_us += dur
        blob = str(e.get("name", "")).lower()
        if e.get("cat") != "kernel":
            blob += " " + e["cat"].replace("gpu_", "")
        seg = None
        for name, needles in tags:
            if any(n in blob for n in needles):
                seg = name
                break
        if seg is None:
            seg = "unattributed"
        elif seg == "attention":
            bwd = any(m in blob for m in _BWD_MARKERS)
            seg = f"{seg}_{'bwd' if bwd else 'fwd'}"
        seg_us[seg] = seg_us.get(seg, 0.0) + dur
        seg_n[seg] = seg_n.get(seg, 0) + 1
    return {
        "segments": {
            k: {"device_ms": round(v / 1e3, 4),
                "events": seg_n[k],
                "frac": round(v / total_us, 4) if total_us else None}
            for k, v in sorted(seg_us.items(), key=lambda kv: -kv[1])},
        "total_device_ms": round(total_us / 1e3, 4),
        "attributed_frac": round(
            1.0 - seg_us.get("unattributed", 0.0) / total_us, 4)
        if total_us else None,
        "note": ("Kineto work events (kernels, copies, sets) classified by "
                 "kernel name; attention split fwd/bwd by name; "
                 "'unattributed' covers elementwise and reduction kernels"),
    }


class _Lanes:
    """The work events of each lane, sorted by start, for window sums."""

    def __init__(self, works: Sequence[dict]):
        self.by_lane: Dict[Tuple[object, object], List[dict]] = {}
        for w in works:
            self.by_lane.setdefault(_lane(w), []).append(w)
        self.starts = {lane: [float(w.get("ts", 0.0)) for w in ws]
                       for lane, ws in self.by_lane.items()}
        # an event can start before a window and reach into it: bound the
        # look-back by the lane's longest event
        self.longest = {lane: max(float(w.get("dur", 0.0)) for w in ws)
                        for lane, ws in self.by_lane.items()}

    def overlap_us(self, lane, w0: float, w1: float) -> float:
        ws = self.by_lane.get(lane)
        if not ws:
            return 0.0
        st = self.starts[lane]
        i = bisect.bisect_left(st, w0 - self.longest[lane])
        total = 0.0
        while i < len(ws) and st[i] < w1:
            end = st[i] + float(ws[i].get("dur", 0.0))
            ov = min(end, w1) - max(st[i], w0)
            if ov > 0:
                total += ov
            i += 1
        return total


def _merged(windows: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for w0, w1 in sorted(windows):
        if out and w0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], w1)
        else:
            out.append([w0, w1])
    return [(a, b) for a, b in out]


def correlate(spans, events: Sequence[dict]) -> dict:
    """Attribute measured device time from a parsed Kineto trace onto host
    spans.

    Mutates matched spans in place: ``device_ns`` becomes the measured
    lane-time, ``device_src`` becomes ``"xplane"``. Unmatched spans keep
    their estimate. Returns correlation stats including a per-op
    measured-vs-estimate table (``by_op``)."""
    span_list = list(spans)
    names = {s.name for s in span_list}
    lanes = classify_lanes(events, names)
    host, _ = lanes
    anns: Dict[str, List[dict]] = {}
    gpu_windows: Dict[object, Dict[tuple, List[Tuple[float, float]]]] = {}
    n_gpu = 0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", HOST_ANNOTATION)
        if cat == HOST_ANNOTATION and e.get("name") in names \
                and _lane(e) in host:
            anns.setdefault(e["name"], []).append(e)
        elif cat == GPU_ANNOTATION and e.get("name") in names:
            ext = _ext_id(e)
            if ext is not None:
                ts = float(e.get("ts", 0.0))
                gpu_windows.setdefault(ext, {}).setdefault(
                    _lane(e), []).append((ts, ts + float(e.get("dur", 0.0))))
                n_gpu += 1
    for lst in anns.values():
        lst.sort(key=lambda e: e.get("ts", 0.0))
    works = work_events(events, names, lanes=lanes)
    lane_works = _Lanes(works)

    by_name: Dict[str, List[HostSpan]] = {}
    for s in span_list:
        by_name.setdefault(s.name, []).append(s)
    correlated = 0
    by_op: Dict[str, dict] = {}
    for name, sps in by_name.items():
        sps.sort(key=lambda s: s.start_ns)
        evs = anns.get(name, [])
        k = min(len(sps), len(evs))
        # aligned from the newest: spans recorded before the trace started
        # have no annotation, extra annotations have no span
        for s, a in zip(sps[len(sps) - k:], evs[len(evs) - k:]):
            wins = gpu_windows.get(_ext_id(a)) if _ext_id(a) is not None \
                else None
            dev_us = 0.0
            if wins:
                for lane, ws in wins.items():
                    for w0, w1 in _merged(ws):
                        dev_us += lane_works.overlap_us(lane, w0, w1)
            else:
                w0 = float(a.get("ts", 0.0))
                w1 = w0 + float(a.get("dur", 0.0))
                for lane in lane_works.by_lane:
                    dev_us += lane_works.overlap_us(lane, w0, w1)
            if dev_us <= 0:
                continue
            row = by_op.setdefault(name, {"op": name, "calls": 0,
                                          "est_ms": 0.0, "xplane_ms": 0.0})
            row["calls"] += 1
            if s.device_src == "estimate" and s.device_ns:
                row["est_ms"] += s.device_ns / 1e6
            row["xplane_ms"] += dev_us / 1e3
            s.device_ns = int(dev_us * 1e3)
            s.device_src = "xplane"
            correlated += 1
    for row in by_op.values():
        row["est_ms"] = round(row["est_ms"], 4)
        row["xplane_ms"] = round(row["xplane_ms"], 4)
        row["xplane_vs_est"] = (round(row["xplane_ms"] / row["est_ms"], 3)
                                if row["est_ms"] > 0 else None)
    return {
        "spans": len(span_list),
        "correlated": correlated,
        "annotations": sum(len(v) for v in anns.values()),
        "gpu_annotations": n_gpu,
        "work_events": len(works),
        "by_op": sorted(by_op.values(), key=lambda r: -r["xplane_ms"]),
    }


# ---------------------------------------------------------------------------
# capture session
# ---------------------------------------------------------------------------
class CaptureSession:
    """One torch-profiler window over the host recorder.

    ``start()`` clears and enables the recorder, starts the device trace
    and flips :func:`annotating`; ``stop()`` reverses all of it, exports
    and parses the trace, correlates spans, and returns (and writes) the
    summary. The recorder must be idle — an active Profiler RECORD window
    owns it (:class:`CaptureBusyError`). Start and stop on one thread."""

    def __init__(self, session_dir: str):
        self.session_dir = session_dir
        self.started = False
        self.spans: list = []
        self.trace_path: Optional[str] = None
        self._prof = None
        self._t0_ns = 0
        self._diag0: Optional[dict] = None

    def start(self):
        global _ANNOTATING
        rec = get_recorder()
        if rec.enabled:
            raise CaptureBusyError(
                "host recorder is already recording (Profiler window or "
                "another capture active)")
        os.makedirs(self.session_dir, exist_ok=True)
        self._prof = start_trace()
        rec.clear()
        rec.enabled = True
        _ANNOTATING = True
        from . import monitor as _monitor
        self._diag0 = _monitor.diag_signals()
        self._t0_ns = now_ns()
        self.started = True
        return self

    def stop_trace(self) -> Optional[str]:
        """Stop the torch profiler and export its trace (the thread that
        started it); idempotent."""
        prof, self._prof = self._prof, None
        if prof is not None:
            self.trace_path = stop_trace(prof, self.session_dir)
        return self.trace_path

    def stop(self, steps: Optional[int] = None, status: str = "complete",
             with_trace: bool = True) -> dict:
        """End the window. `with_trace=False` (the cap's timer, on another
        thread) leaves the device trace running for :meth:`stop_trace` on
        the starting thread, and summarizes the host spans alone."""
        global _ANNOTATING
        rec = get_recorder()
        _ANNOTATING = False
        rec.enabled = False
        wall_s = max(0.0, (now_ns() - self._t0_ns) / 1e9)
        self.spans = rec.collect()
        trace_error = None
        if with_trace:
            try:
                self.stop_trace()
            except Exception as e:
                trace_error = f"{type(e).__name__}: {e}"
        else:
            trace_error = ("finalized by the cap's timer: the device trace "
                           "stops at the training thread's next step")
        self.started = False
        summary = self._summarize(wall_s, steps, status, trace_error,
                                  with_trace)
        try:
            with open(os.path.join(self.session_dir, "summary.json"),
                      "w") as f:
                json.dump(summary, f, indent=1)
        except OSError:
            pass
        return summary

    def _summarize(self, wall_s: float, steps: Optional[int], status: str,
                   trace_error: Optional[str], with_trace: bool) -> dict:
        from .statistic import StatisticData, summary_report
        summary = {
            "status": status,
            "ts": time.time(),
            "session_dir": self.session_dir,
            "wall_s": round(wall_s, 4),
            "steps": steps,
        }
        if trace_error:
            summary["trace_error"] = trace_error
        trace_path = find_trace_file(self.session_dir) if with_trace \
            else None
        summary["trace_path"] = trace_path
        if trace_path:
            try:
                doc = load_trace(trace_path)
                evs = doc.get("traceEvents", [])
                summary["correlation"] = correlate(self.spans, evs)
                summary["segments"] = segment_breakdown(evs)
            except Exception as e:
                summary["parse_error"] = f"{type(e).__name__}: {e}"
        summary["device_time"] = {
            "rows": _device_time.split_rows(self.spans),
            "mode": "xplane" if any(s.device_src == "xplane"
                                    for s in self.spans) else "estimate",
        }
        try:
            summary["summary_table"] = summary_report(
                StatisticData(self.spans))
        except Exception as e:
            summary["table_error"] = f"{type(e).__name__}: {e}"
        if self._diag0 is not None:
            try:
                from . import monitor as _monitor
                summary["diagnosis"] = _monitor.diagnose_window(
                    self._diag0, wall_s, steps=steps or 0)
            except Exception as e:
                summary["diagnosis_error"] = f"{type(e).__name__}: {e}"
        return summary


# ---------------------------------------------------------------------------
# on-demand armed capture (the /profile backend)
# ---------------------------------------------------------------------------
def _default_session_root() -> str:
    return os.environ.get(
        "PADDLE_TPU_PROFILE_DIR",
        os.path.join(tempfile.gettempdir(),
                     f"paddle_tpu_torch_profile_{os.getpid()}"))


def capture_timeout() -> float:
    """Hard wall-clock cap on one capture (PADDLE_TPU_PROFILE_TIMEOUT)."""
    return env_float("PADDLE_TPU_PROFILE_TIMEOUT", DEFAULT_CAPTURE_TIMEOUT)


class ProfileCapture:
    """Exactly-one-at-a-time capture armed around the next N train steps.

    `arm(steps=N)` -> the next `note_step` starts the trace, the one
    after opens the first of N step spans, and the N-th span's end stops
    the trace and builds the summary. The step between the start and the
    first span is a lead-in (`LEAD_IN_STEPS`): Kineto drops a window's
    GPU records that it stamps before the window's start, and in a
    long-lived process its GPU clock runs ahead of the host's
    (`tools/profile_torch_kineto_drift.py`: on an H100 a window lost the
    first 1 of a graph replay's 17 kernels 19 s into the process, 8 at
    129 s, none behind a 50 ms lead-in). The summary's `segments` cover
    the whole trace, the lead-in step included; `correlation` and
    `device_time` cover the spans. A `threading.Timer` at the
    hard cap finalizes a window the step flow never closes (stalled job,
    armed-but-idle loop) — a capture can never outlive the cap; the
    device trace of a window the timer finalized is stopped on the
    training thread at its next step.

    While recording, every inter-`note_step` interval is bracketed in a
    ``train_step`` record_function range + host span (opened/closed on the
    training thread, which is the thread calling note_step): a captured
    step is ONE graph replay, so without this a capture of the
    production path would correlate nothing — with it, the summary
    carries measured per-STEP device time next to whatever RecordEvent
    spans the loop contributed."""

    def __init__(self):
        self._lock = threading.Lock()
        self.state = "idle"  # idle | armed | recording
        self._session: Optional[CaptureSession] = None
        self._steps = 0
        self._start_step: Optional[int] = None
        self._end_step: Optional[int] = None
        self._timer: Optional[threading.Timer] = None
        self._done = threading.Event()
        self._done.set()
        self._seq = 0
        self._step_range = None    # open record_function of the step
        self._step_t0: Optional[int] = None
        self._owner: Optional[threading.Thread] = None  # the training thread
        # (session, open range) the timer finalized: its trace is still
        # running on the owner thread
        self._orphan: Optional[tuple] = None
        self.last_summary: Optional[dict] = None

    def arm(self, steps: int, session_dir: Optional[str] = None,
            timeout_s: Optional[float] = None) -> dict:
        steps = int(steps)
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        cap = float(timeout_s) if timeout_s else capture_timeout()
        with self._lock:
            self._reap_dead_orphan_locked()
            if self.state != "idle":
                raise CaptureBusyError(
                    f"capture already {self.state} "
                    f"(one session at a time)")
            if self._orphan is not None:
                raise CaptureBusyError(
                    "the last capture's device trace is still stopping "
                    "(it stops at the training thread's next step; one "
                    "session at a time)")
            if get_recorder().enabled:
                raise CaptureBusyError(
                    "host recorder is busy (Profiler window active)")
            self._seq += 1
            if session_dir is None:
                session_dir = os.path.join(
                    _default_session_root(),
                    f"session_{self._seq}_{int(time.time())}")
            self._session = CaptureSession(session_dir)
            self._steps = steps
            self._start_step = self._end_step = None
            self.state = "armed"
            self.last_summary = None
            self._done.clear()
            self._timer = threading.Timer(cap, self._on_timeout)
            self._timer.daemon = True
            self._timer.start()
            return {"status": "armed", "steps": steps,
                    "session_dir": session_dir, "timeout_s": cap}

    def on_step(self, step: int):
        """Drive the armed window; cheap no-op while idle. Never raises."""
        if self.state == "idle" and self._orphan is None:
            return
        try:
            with self._lock:
                self._stop_orphan_locked()
                if self.state == "armed":
                    self._owner = threading.current_thread()
                    self._session.start()
                    # the step after the start is a lead-in (LEAD_IN_STEPS)
                    self._start_step = int(step) + LEAD_IN_STEPS
                    self._end_step = self._start_step + self._steps
                    self.state = "recording"
                elif self.state == "recording":
                    if self._step_t0 is not None:  # none in the lead-in
                        self._close_step_span(push=True)
                    if int(step) >= self._end_step:
                        self._finalize_locked("complete")
                    else:
                        self._open_step_span()
        except CaptureBusyError as e:
            with self._lock:
                if self.state == "armed":
                    self._abort_locked(f"{e}")
        except Exception as e:  # capture must never take down training
            with self._lock:
                if self.state != "idle":
                    self._abort_locked(f"{type(e).__name__}: {e}")

    def _on_owner(self) -> bool:
        return self._owner is threading.current_thread()

    def _open_step_span(self):
        """Open the next inter-step range (training thread)."""
        self._step_t0 = now_ns()
        self._step_range = torch.profiler.record_function("train_step")
        self._step_range.__enter__()

    def _close_step_span(self, push: bool):
        """Close the open step range; `push` records it as a
        ``train_step`` host span."""
        rng, self._step_range = self._step_range, None
        if rng is not None:
            rng.__exit__(None, None, None)
        if push and self._step_t0 is not None:
            rec = get_recorder()
            if rec.enabled:
                rec.push(HostSpan(
                    name="train_step", start_ns=self._step_t0,
                    end_ns=now_ns(), tid=threading.get_ident(),
                    event_type="ProfileStep"))
        self._step_t0 = None

    def _stop_orphan_locked(self):
        """Stop the device trace of a window the timer finalized (on the
        training thread, which started it)."""
        if self._orphan is None or not self._on_owner():
            return
        sess, rng = self._orphan
        self._orphan = None
        try:
            if rng is not None:
                rng.__exit__(None, None, None)
            path = sess.stop_trace()
        except Exception as e:
            path = None
            if self.last_summary is not None:
                self.last_summary["trace_error"] = \
                    f"{type(e).__name__}: {e}"
        if self.last_summary is not None and \
                self.last_summary.get("session_dir") == sess.session_dir:
            self.last_summary["trace_path"] = path

    def _reap_dead_orphan_locked(self):
        """An orphan whose training thread has ended can never be stopped
        there; its trace went with the thread's profiler state."""
        if self._orphan is not None and self._owner is not None \
                and not self._owner.is_alive():
            self._orphan = None

    def _on_timeout(self):
        with self._lock:
            if self.state == "recording":
                self._finalize_locked("timeout")
            elif self.state == "armed":
                self._abort_locked("timed out before any step was observed",
                                   status="timeout")

    def _finalize_locked(self, status: str):
        on_owner = self._on_owner()
        if on_owner:
            self._close_step_span(push=False)  # no-op when already closed
        else:
            self._step_t0 = None
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        steps_seen = 0
        if self._start_step is not None:
            steps_seen = min(self._steps,
                             max(0, self._end_step - self._start_step))
            if status == "timeout":
                steps_seen = 0  # unknown; the summary's wall_s is the truth
        try:
            summary = self._session.stop(
                steps=self._steps if status == "complete" else steps_seen,
                status=status, with_trace=on_owner)
        except Exception as e:
            summary = {"status": "error", "ts": time.time(),
                       "error": f"{type(e).__name__}: {e}",
                       "session_dir": self._session.session_dir}
            status = "error"
        if not on_owner and self._session._prof is not None:
            self._orphan = (self._session, self._step_range)
            self._step_range = None
        self.last_summary = summary
        self.state = "idle"
        if _metrics_mod.enabled():
            _M_CAPTURES.inc(status=summary.get("status", status))
        _events_mod.emit(
            "profile_capture",
            severity="info" if status == "complete" else "warn",
            status=summary.get("status", status),
            session_dir=self._session.session_dir,
            correlated=(summary.get("correlation") or {}).get("correlated"))
        self._done.set()

    def _abort_locked(self, reason: str, status: str = "error"):
        on_owner = self._on_owner()
        if on_owner:
            try:
                self._close_step_span(push=False)
            except Exception:
                self._step_range = None
        else:
            self._step_t0 = None
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        sess = self._session
        if sess is not None and sess.started:
            try:
                sess.stop(status=status, with_trace=on_owner)
            except Exception:
                pass
            if not on_owner and sess._prof is not None:
                self._orphan = (sess, self._step_range)
                self._step_range = None
        self.last_summary = {"status": status, "ts": time.time(),
                             "error": reason,
                             "session_dir": sess.session_dir if sess
                             else None}
        self.state = "idle"
        if _metrics_mod.enabled():
            _M_CAPTURES.inc(status=status)
        _events_mod.emit("profile_capture", severity="warn", status=status,
                         error=reason)
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Block until the current capture finalizes; returns its summary
        (None if still in flight at `timeout`)."""
        if not self._done.wait(timeout):
            return None
        return self.last_summary

    def status(self) -> dict:
        with self._lock:
            st = {"state": self.state}
            if self.state != "idle" and self._session is not None:
                st["session_dir"] = self._session.session_dir
                st["steps"] = self._steps
                if self._end_step is not None:
                    st["end_step"] = self._end_step
            if self._orphan is not None:
                st["trace_stopping"] = True
            if self.last_summary is not None:
                st["last"] = self.last_summary
            return st


_default_capture = ProfileCapture()


def default_capture() -> ProfileCapture:
    """The process-wide armed-capture manager (`/profile`'s backend)."""
    return _default_capture
