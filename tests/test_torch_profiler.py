"""The port's host profiler (``paddle_tpu_torch.profiler``: recorder,
statistic, timer, RecordEvent, Profiler) against the reference's on the
same inputs: scheduler states over a grid, Benchmark/TimeAverager
reports under one injected clock, the summary table's text, RecordEvent
nesting and the chrome export's schema; the recorder's concurrency
contract; Profiler windows on the CPU."""
import itertools
import json
import threading
import time

import numpy as np
import pytest

from paddle_tpu import profiler as jprof
from paddle_tpu.profiler import recorder as jrecorder
from paddle_tpu.profiler import statistic as jstatistic
from paddle_tpu.profiler import timer as jtimer
from paddle_tpu_torch import profiler as prof
from paddle_tpu_torch.profiler import recorder, statistic, timer
from paddle_tpu_torch.profiler.recorder import HostSpan, get_recorder, now_ns


@pytest.fixture()
def clean_recorders():
    recs = (get_recorder(), jrecorder.get_recorder())
    for r in recs:
        r.enabled = False
        r.clear()
    yield recs[0]
    for r in recs:
        r.enabled = False
        r.clear()


def test_all_names_of_the_reference_are_exported():
    assert prof.__all__ == jprof.__all__
    for name in prof.__all__:
        assert getattr(prof, name) is not None


# (closed, ready, record): every combination of small windows
_WINDOWS = [w for w in itertools.product((0, 1, 2), (0, 1, 2), (1, 2, 3))
            if w[2] >= 1][::3]


@pytest.mark.parametrize("closed,ready,record", _WINDOWS)
def test_make_scheduler_states_equal_the_reference(closed, ready, record):
    for repeat, skip_first in itertools.product((0, 1, 2), (0, 1, 3)):
        kw = dict(closed=closed, ready=ready, record=record, repeat=repeat,
                  skip_first=skip_first)
        mine = prof.make_scheduler(**kw)
        ref = jprof.make_scheduler(**kw)
        got = [mine(i).name for i in range(24)]
        want = [ref(i).name for i in range(24)]
        assert got == want, kw


class _Clock:
    """time.perf_counter's stand-in: each reading advances by the next
    of a seeded sequence of intervals."""

    def __init__(self, seed):
        self.dt = np.random.default_rng(seed).uniform(0.001, 0.05, 400)
        self.i, self.t = 0, 100.0

    def __call__(self):
        self.t += float(self.dt[self.i % len(self.dt)])
        self.i += 1
        return self.t


def _drive_benchmark(mod, monkeypatch, seed, samples):
    monkeypatch.setattr(time, "perf_counter", _Clock(seed))
    b = mod.Benchmark()
    out = [b.step_info(), b.report()]
    b.step()  # without begin(): arms only
    b.begin()
    for i, n in enumerate(samples):
        if i % 2 == 0:
            b.before_reader()
            b.after_reader()
        b.step(n)
        out.append(b.step_info("tokens"))
    b.end()
    out.append(b.report())
    avg = mod.TimeAverager()
    out.append((avg.get_average(), avg.get_ips_average()))
    for i, n in enumerate(samples):
        avg.record(0.01 * (i + 1), n)
    out.append((avg.get_average(), avg.get_ips_average(), avg.count,
                avg.total_samples, avg.total_time))
    b.reset()
    out.append(b.report())
    return out


@pytest.mark.parametrize("seed,samples", [
    (0, [32, 32, 32, 32]), (1, [None, None, None]), (2, [8, None, 16, 0]),
    (3, [])])
def test_benchmark_reports_equal_the_reference(monkeypatch, seed, samples):
    got = _drive_benchmark(timer, monkeypatch, seed, samples)
    want = _drive_benchmark(jtimer, monkeypatch, seed, samples)
    assert got == want


def _spans(mod, seed, with_device):
    rng = np.random.default_rng(seed)
    names = ["matmul", "layer_norm", "train_step", "a_very_long_span_name"]
    out = []
    t = 1_000_000
    for i in range(24):
        dur = int(rng.integers(1_000, 5_000_000))
        s = mod.HostSpan(name=names[int(rng.integers(0, len(names)))],
                         start_ns=t, end_ns=t + dur, tid=int(i % 3),
                         event_type=["Operator", "UserDefined"][i % 2])
        if with_device and i % 3:
            s.device_ns = int(rng.integers(100, 4_000_000))
            s.device_src = ["estimate", "measured", "xplane"][i % 3]
        out.append(s)
        t += int(rng.integers(0, 3_000_000))
    return out


@pytest.mark.parametrize("seed,with_device", [(0, False), (1, True),
                                              (2, True)])
def test_summary_report_text_equals_the_reference(seed, with_device):
    mine = statistic.StatisticData(_spans(recorder, seed, with_device))
    ref = jstatistic.StatisticData(_spans(jrecorder, seed, with_device))
    for key in statistic.SortedKeys:
        jkey = jstatistic.SortedKeys[key.name]
        for unit in ("ms", "us", "s"):
            assert statistic.summary_report(mine, key, unit) == \
                jstatistic.summary_report(ref, jkey, unit)
    assert statistic.summary_report(statistic.StatisticData([])) == \
        jstatistic.summary_report(jstatistic.StatisticData([]))


def _nested_window(pkg, path):
    p = pkg.Profiler(targets=[pkg.ProfilerTarget.CPU])
    p.start()
    with pkg.RecordEvent("outer"):
        with pkg.RecordEvent("mid"):
            with pkg.RecordEvent("leaf"):
                pass
            with pkg.RecordEvent("leaf"):
                pass
        with pkg.RecordEvent("mid", event_type="Forward"):
            pass

    def side():
        with pkg.RecordEvent("side"):
            time.sleep(0.001)

    th = threading.Thread(target=side)
    th.start()
    th.join()
    # a span left open across the window's close pops without a parent
    late = pkg.RecordEvent("late")
    late.begin()
    p.stop()
    late.end()
    p.export(str(path))
    return json.load(open(path))


def test_record_event_nesting_and_chrome_schema_equal_the_reference(
        tmp_path, clean_recorders):
    mine = _nested_window(prof, tmp_path / "mine.json")
    ref = _nested_window(jprof, tmp_path / "ref.json")

    def rows(doc):
        return [(e["name"], e["cat"], e["ph"], e["args"].get("parent"))
                for e in doc["traceEvents"]]

    assert rows(mine) == rows(ref)
    assert ("leaf", "UserDefined", "X", "mid") in rows(mine)
    assert set(mine) == set(ref)
    assert mine["displayTimeUnit"] == ref["displayTimeUnit"]
    for a, b in zip(mine["traceEvents"], ref["traceEvents"]):
        assert set(a) == set(b)
        assert isinstance(a["ts"], float) and isinstance(a["tid"], int)
    ts = [e["ts"] for e in mine["traceEvents"]]
    assert ts == sorted(ts)
    assert len({e["tid"] for e in mine["traceEvents"]}) == 2
    # nothing stays on a thread's stack after the window
    assert get_recorder().span_stack() == []


def test_recorder_concurrent_record_and_collect(clean_recorders):
    """collect() drains per thread under the buffer lock: spans recorded
    mid-collect are neither lost nor duplicated."""
    rec = clean_recorders
    rec.enabled = True
    n_threads, per_thread = 4, 400
    stop_collect = threading.Event()
    collected, errors = [], []

    def producer(tid):
        try:
            for i in range(per_thread):
                t = now_ns()
                rec.push(HostSpan(name=f"rectest_{tid}_{i}", start_ns=t,
                                  end_ns=t + 1, tid=threading.get_ident()))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def collector():
        while not stop_collect.is_set():
            collected.extend(rec.collect())

    cth = threading.Thread(target=collector)
    cth.start()
    producers = [threading.Thread(target=producer, args=(t,))
                 for t in range(n_threads)]
    for t in producers:
        t.start()
    for t in producers:
        t.join()
    stop_collect.set()
    cth.join()
    collected.extend(rec.collect())
    assert not errors
    names = [s.name for s in collected if s.name.startswith("rectest_")]
    assert len(names) == n_threads * per_thread
    assert len(set(names)) == len(names)
    # the producers have ended: their buffers were pruned after the drain
    assert rec.collect() == []
    assert len(rec._buffers) <= 2


def test_profiler_windows_on_the_cpu(tmp_path, clean_recorders):
    traces = []
    sch = prof.make_scheduler(closed=1, ready=1, record=2, repeat=2)
    handler = prof.export_chrome_tracing(str(tmp_path / "traces"), "w")
    p = prof.Profiler(targets=[prof.ProfilerTarget.CPU], scheduler=sch,
                      on_trace_ready=lambda pr: traces.append(
                          ([s.name for s in pr._spans], handler(pr))))
    with p:
        for i in range(10):
            with prof.RecordEvent(f"step{i}"):
                pass
            p.step(num_samples=4)
    # windows: steps 2-3 and 6-7 (closed 1, ready 1, record 2, twice)
    assert [names for names, _ in traces] == [["step2", "step3"],
                                              ["step6", "step7"]]
    for _, path in traces:
        doc = prof.load_profiler_result(path)
        assert doc["metadata"]["producer"] == "paddle_tpu_torch.profiler"
    assert "ips" in p.step_info()
    # (start, end) tuples as in the reference: record steps [2, 4)
    p2 = prof.Profiler(targets=[prof.ProfilerTarget.CPU], scheduler=(2, 4))
    p2.start()
    for i in range(6):
        with prof.RecordEvent(f"s{i}"):
            pass
        p2.step()
    p2.stop()
    assert [s.name for s in p2._spans] == ["s2", "s3"]
    assert "s2" in p2.summary()
    assert p2.xplane_stats is None  # no device trace on the CPU


def test_profiler_targets_follow_the_device_rule(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        prof.Profiler()
    with pytest.raises(RuntimeError, match="GPU"):
        prof.Profiler(targets=[prof.ProfilerTarget.CPU,
                               prof.ProfilerTarget.GPU])
    with pytest.raises(ValueError, match="TPU"):
        prof.Profiler(targets=[prof.ProfilerTarget.TPU])
    assert prof.Profiler(targets=[prof.ProfilerTarget.CPU]).targets == [
        prof.ProfilerTarget.CPU]


def test_a_ready_step_leads_the_device_trace_in(tmp_path, monkeypatch,
                                                clean_recorders):
    """With the GPU target and a trace_dir, the window's torch profiler
    starts at the READY step before the window (a lead-in) and stops at
    the window's end; without a READY step it starts at the first RECORD
    step; a READY step no window follows stops it unexported."""
    import torch
    from paddle_tpu_torch.profiler import xplane
    calls = []

    class _Prof:
        def stop(self):
            calls.append(("dropped", p.step_num))

    def start_trace():
        calls.append(("start", p.step_num))
        return _Prof()

    def stop_trace(prof, trace_dir, name):
        calls.append(("stop", p.step_num))
        path = tmp_path / name
        path.write_text('{"traceEvents": []}')
        return str(path)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(xplane, "start_trace", start_trace)
    monkeypatch.setattr(xplane, "stop_trace", stop_trace)
    targets = [prof.ProfilerTarget.CPU, prof.ProfilerTarget.GPU]
    for ready, want in ((1, [("start", 1), ("stop", 4)]),
                        (0, [("start", 1), ("stop", 3)])):
        calls.clear()
        p = prof.Profiler(targets=targets, trace_dir=str(tmp_path),
                          scheduler=prof.make_scheduler(
                              closed=1, ready=ready, record=2, repeat=1))
        p.start()
        for _ in range(6):
            with prof.RecordEvent("s"):
                assert xplane.annotating() == (p.current_state in (
                    prof.ProfilerState.RECORD,
                    prof.ProfilerState.RECORD_AND_RETURN))
            p.step()
        p.stop()
        assert calls == want, (ready, calls)
        assert [s.name for s in p._spans] == ["s", "s"]
        assert p.xplane_stats["spans"] == 2
    calls.clear()
    p = prof.Profiler(targets=targets, trace_dir=str(tmp_path),
                      scheduler=lambda step: prof.ProfilerState.READY)
    p.start()
    p.stop()
    assert calls == [("start", 0), ("dropped", 0)]
