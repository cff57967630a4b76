"""The port's device-trace correlation (``profiler/xplane.py`` over
Kineto's chrome export): ``classify_lanes``, ``work_events``,
``correlate`` and ``segment_breakdown`` on hand-built Kineto event lists
(kernels, copies, ``user_annotation`` and its ``gpu_user_annotation``
projections, a graph replay's kernels under one annotation); the
``ProfileCapture`` contract of the reference (arm, step, finalize, the
cap, one session at a time) with the torch profiler started and stopped
on the stepping thread; one real ``CaptureSession`` over the CPU
activity."""
import json
import os
import threading

import pytest
import torch

from paddle_tpu_torch.profiler import RecordEvent, device_time, xplane
from paddle_tpu_torch.profiler.recorder import HostSpan, get_recorder
from paddle_tpu_torch.profiler.statistic import StatisticData, summary_report

HOST, GPU = (100, 100), (0, 7)


def _ev(name, ts, dur, cat, lane=HOST, ext=None, **args):
    if ext is not None:
        args["External id"] = ext
    return {"ph": "X", "cat": cat, "name": name, "pid": lane[0],
            "tid": lane[1], "ts": float(ts), "dur": float(dur),
            "args": args}


def _kernel(name, ts, dur, lane=GPU):
    return _ev(name, ts, dur, "kernel", lane)


def _trace():
    """Two steps of a loop: each a `train_step` annotation (ext 1, 2)
    that launched a graph replay (three kernels and a copy on stream 7)
    and, inside the first, a `decode` annotation whose kernels ran on a
    second stream (its projection there); a kernel outside every window;
    CPU ops and runtime calls on the host lane; Kineto's metadata."""
    evs = [
        {"ph": "M", "name": "process_name", "pid": 100, "tid": 0,
         "args": {"name": "python"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": "GPU 0"}},
        _ev("train_step", 0, 100, "user_annotation", ext=1),
        _ev("cudaGraphLaunch", 5, 10, "cuda_runtime"),
        _ev("decode", 20, 30, "user_annotation", ext=3),
        _ev("aten::mm", 22, 5, "cpu_op", ext=4),
        _ev("train_step", 10, 140, "gpu_user_annotation", GPU, ext=1),
        _kernel("layer_norm_fwd_hold_kernel", 10, 20),
        _kernel("flash_fwd_tf32_kernel<64, false>", 30, 50),
        _ev("Memcpy DtoH (Device -> Pinned)", 80, 10, "gpu_memcpy", GPU),
        _kernel("flash_bwd_tf32_kernel<64, false>", 90, 60),
        _ev("decode", 40, 25, "gpu_user_annotation", (0, 9), ext=3),
        _kernel("paged_attn_part_kernel", 40, 10, (0, 9)),
        _kernel("paged_attn_merge_kernel", 55, 10, (0, 9)),
        _ev("train_step", 200, 100, "user_annotation", ext=2),
        _ev("train_step", 205, 60, "gpu_user_annotation", GPU, ext=2),
        _kernel("ce_fwd_stream_kernel", 205, 20),
        _ev("Memset (Device)", 225, 5, "gpu_memset", GPU),
        _kernel("multi_tensor_apply_kernel", 230, 35),
        _kernel("unrelated_kernel", 400, 50),
    ]
    return evs


def _span(name, start_us, end_us, device_ns=None, src=None):
    return HostSpan(name=name, start_ns=int(start_us * 1e3),
                    end_ns=int(end_us * 1e3), tid=1, device_ns=device_ns,
                    device_src=src)


def test_lanes_and_work_events():
    evs = _trace()
    host, work = xplane.classify_lanes(evs)
    assert host == {HOST} and work == {GPU, (0, 9)}
    works = xplane.work_events(evs)
    assert [e["cat"] for e in works].count("kernel") == 8
    assert {e["cat"] for e in works} == set(xplane.WORK_CATS)
    assert [e["ts"] for e in works] == sorted(e["ts"] for e in works)
    assert all(e["name"] not in ("train_step", "decode") for e in works)


def test_correlate_sums_each_span_over_its_streams():
    spans = [_span("train_step", 0, 100, 5_000, "estimate"),
             _span("train_step", 200, 300),
             _span("decode", 20, 50)]
    stats = xplane.correlate(spans, _trace())
    # step 1: the work under its projection on stream 7 (LN 20, flash fwd
    # 50, copy 10, flash bwd 60), not the decode's stream; step 2: 60
    assert [s.device_ns for s in spans] == [140_000, 60_000, 20_000]
    assert all(s.device_src == "xplane" for s in spans)
    assert stats["correlated"] == 3 and stats["annotations"] == 3
    assert stats["gpu_annotations"] == 3 and stats["work_events"] == 10
    row = next(r for r in stats["by_op"] if r["op"] == "train_step")
    assert row == {"op": "train_step", "calls": 2, "est_ms": 0.005,
                   "xplane_ms": 0.2, "xplane_vs_est": 40.0}


def test_correlate_aligns_from_the_newest_and_falls_back_to_host_windows():
    evs = [e for e in _trace() if e.get("cat") != "gpu_user_annotation"]
    # three spans, two annotations: the oldest span started before the
    # trace and keeps its estimate
    spans = [_span("train_step", -500, -400, 7_000, "estimate"),
             _span("train_step", 0, 100), _span("train_step", 200, 300)]
    stats = xplane.correlate(spans, evs)
    assert spans[0].device_ns == 7_000 and spans[0].device_src == "estimate"
    # no projections: the host windows [0, 100) and [200, 300), over every
    # stream (the decode's kernels on stream 9 fall in the first)
    assert spans[1].device_ns == (20 + 50 + 10 + 10 + 10 + 10) * 1000
    assert spans[2].device_ns == (20 + 5 + 35) * 1000
    assert stats["correlated"] == 2 and stats["gpu_annotations"] == 0
    # a span whose window holds no work stays as it was
    idle = [_span("idle", 0, 1)]
    assert xplane.correlate(idle, evs + [
        _ev("idle", 1000, 1, "user_annotation")])["correlated"] == 0
    assert idle[0].device_src is None


def test_segment_breakdown_by_kernel_name():
    seg = xplane.segment_breakdown(_trace())
    got = {k: (v["device_ms"], v["events"])
           for k, v in seg["segments"].items()}
    assert got == {"attention_bwd": (0.06, 1), "attention_fwd": (0.07, 3),
                   "unattributed": (0.05, 1), "optimizer": (0.035, 1),
                   "ln": (0.02, 1), "loss": (0.02, 1), "copy": (0.015, 2)}
    assert seg["total_device_ms"] == 0.27
    assert seg["attributed_frac"] == round(1 - 50 / 270, 4)
    empty = xplane.segment_breakdown([])
    assert empty["segments"] == {} and empty["attributed_frac"] is None


def test_load_and_find_trace_files(tmp_path):
    import gzip
    doc = {"traceEvents": _trace()}
    plain = tmp_path / "a.pt.trace.json"
    plain.write_text(json.dumps(doc))
    gz = tmp_path / "b.pt.trace.json.gz"
    with gzip.open(gz, "wt") as f:
        json.dump(doc, f)
    os.utime(plain, (1, 1))
    assert xplane.find_trace_file(str(tmp_path)) == str(gz)
    assert xplane.load_trace(str(gz)) == xplane.load_trace(str(plain)) == doc
    assert xplane.find_trace_file(str(tmp_path / "none")) is None


def test_split_rows_and_table_show_the_xplane_source():
    spans = [_span("train_step", 0, 100), _span("op", 0, 10, 3000,
                                                "estimate")]
    xplane.correlate(spans, _trace())
    rows = device_time.split_rows(spans)
    assert [r["src"] for r in rows] == ["xplane", "estimate"]
    table = summary_report(StatisticData(spans))
    assert "Dev(ms)" in table and "xplane" in table


@pytest.fixture()
def idle_recorder():
    rec = get_recorder()
    rec.enabled = False
    rec.clear()
    yield rec
    rec.enabled = False
    rec.clear()
    assert not torch.autograd.profiler._is_profiler_enabled


def _work(n=32):
    a = torch.ones(n, n)
    return (a @ a).sum()


def test_capture_session_over_the_cpu_activity(tmp_path, idle_recorder):
    sess = xplane.CaptureSession(str(tmp_path / "s")).start()
    assert xplane.annotating()
    with pytest.raises(xplane.CaptureBusyError):
        xplane.CaptureSession(str(tmp_path / "s2")).start()
    with RecordEvent("outer"):
        for _ in range(3):
            with RecordEvent("inner"):
                _work()
    summ = sess.stop(steps=1)
    assert not xplane.annotating() and not idle_recorder.enabled
    assert summ["status"] == "complete" and "trace_error" not in summ
    assert summ["trace_path"] == os.path.join(str(tmp_path / "s"),
                                              xplane.TRACE_FILE)
    # the ranges landed as user annotations, one a span; the CPU trace has
    # no work on a card, so nothing correlates
    corr = summ["correlation"]
    assert (corr["spans"], corr["annotations"], corr["work_events"]) == \
        (4, 4, 0)
    doc = xplane.load_trace(summ["trace_path"])
    names = [e["name"] for e in doc["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert sorted(names) == ["inner"] * 3 + ["outer"]
    assert "inner" in summ["summary_table"]
    assert summ["diagnosis"]["dominant"]
    assert json.load(open(tmp_path / "s" / "summary.json"))["status"] == \
        "complete"


def test_profile_capture_arm_step_finalize(tmp_path, idle_recorder):
    cap = xplane.ProfileCapture()
    ack = cap.arm(2, session_dir=str(tmp_path / "p1"), timeout_s=60)
    assert ack["status"] == "armed" and cap.status()["state"] == "armed"
    with pytest.raises(xplane.CaptureBusyError, match="one session"):
        cap.arm(1, session_dir=str(tmp_path / "p2"))
    step = 0
    while cap.state != "idle":
        step += 1
        _work()
        cap.on_step(step)
        # the step after the trace's start is its lead-in: no span yet
        assert (cap._step_t0 is None) == (step in (1, 4))
        assert step < 10, "capture never finalized"
    summ = cap.wait(1)
    assert summ["status"] == "complete" and summ["steps"] == 2
    assert step == 2 + xplane.LEAD_IN_STEPS + 1
    # every inter-step interval is one train_step span and annotation
    assert summ["correlation"]["annotations"] == 2
    assert "train_step" in summ["summary_table"]
    assert cap.status()["last"]["status"] == "complete"
    cap.on_step(step + 1)  # idle: a no-op


def test_profile_capture_armed_but_stalled_times_out(tmp_path,
                                                     idle_recorder):
    cap = xplane.ProfileCapture()
    cap.arm(1, session_dir=str(tmp_path / "p4"), timeout_s=0.2)
    summ = cap.wait(5)
    assert summ["status"] == "timeout" and cap.state == "idle"
    cap.arm(1, session_dir=str(tmp_path / "p5"), timeout_s=60)
    for step in (1, 2, 3):  # start, lead-in, one span
        cap.on_step(step)
    assert cap.wait(1)["status"] == "complete"


def test_profile_capture_capped_mid_flight_stops_on_the_step_thread(
        tmp_path, idle_recorder):
    """The cap's timer finalizes the window from its own thread with the
    host spans alone; the torch profiler, which belongs to the stepping
    thread, stops at that thread's next step, and its trace lands in the
    session."""
    cap = xplane.ProfileCapture()
    cap.arm(100, session_dir=str(tmp_path / "p6"), timeout_s=0.5)
    done = threading.Event()
    seen = {}

    def loop():
        _work()
        cap.on_step(1)  # starts recording; steps then stall
        assert cap.wait(10)["status"] == "timeout"
        seen["enabled_after_timeout"] = \
            torch.autograd.profiler._is_profiler_enabled
        seen["busy"] = None
        try:
            cap.arm(1, session_dir=str(tmp_path / "p7"))
        except xplane.CaptureBusyError as e:
            seen["busy"] = str(e)
        cap.on_step(2)  # the stepping thread stops the trace
        seen["enabled_after_step"] = \
            torch.autograd.profiler._is_profiler_enabled
        done.set()

    th = threading.Thread(target=loop)
    th.start()
    th.join(30)
    assert done.is_set()
    assert seen["enabled_after_timeout"] is True
    assert "still stopping" in seen["busy"]
    assert seen["enabled_after_step"] is False
    summ = cap.last_summary
    assert summ["status"] == "timeout" and "timer" in summ["trace_error"]
    assert summ["trace_path"] == os.path.join(str(tmp_path / "p6"),
                                              xplane.TRACE_FILE)
    assert os.path.exists(summ["trace_path"])
    assert "trace_stopping" not in cap.status()
    # and the slot is reusable
    cap.arm(1, session_dir=str(tmp_path / "p8"), timeout_s=60)
    for step in (3, 4, 5):
        cap.on_step(step)
    assert cap.wait(1)["status"] == "complete"


def test_profile_capture_refuses_a_busy_recorder(tmp_path, idle_recorder):
    cap = xplane.ProfileCapture()
    idle_recorder.enabled = True
    with pytest.raises(xplane.CaptureBusyError, match="busy"):
        cap.arm(1, session_dir=str(tmp_path / "p9"))
    idle_recorder.enabled = False
    cap.arm(1, session_dir=str(tmp_path / "p9"), timeout_s=60)
    idle_recorder.enabled = True  # a Profiler window opened meanwhile
    cap.on_step(1)
    summ = cap.wait(1)
    assert summ["status"] == "error" and "recording" in summ["error"]
    assert cap.state == "idle"
