"""The port's step-window monitor (``profiler/monitor.py``) against the
reference's: ``make_step_record`` on the same inputs, records from the
port's ``Model.fit`` that pass both packages' ``validate_step_record``,
``diagnose_window`` on the same clock deltas; and the device-memory
sampling of ``profiler/metrics.py`` (``torch.cuda.memory_stats`` on a
card, nothing on the CPU)."""
import json

import numpy as np
import pytest
import torch

from paddle_tpu.profiler import monitor as jmonitor
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.hapi import callbacks as cb
from paddle_tpu_torch.io import Dataset
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.profiler import device_time, metrics, monitor
from paddle_tpu_torch.profiler import server, watchdog


# keyword sets: a full window, no samples or FLOPs, a zero-length window,
# a data wait past the wall, device memory
_RECORDS = [
    dict(step=40, window_steps=20, window_time_s=0.25, samples=2560,
         data_wait_s=0.0075, flops_per_step=1.2e12, peak_flops=989e12,
         retraces=1),
    dict(step=3, window_steps=3, window_time_s=0.5),
    dict(step=0, window_steps=0, window_time_s=0.0, samples=8),
    dict(step=7, window_steps=2, window_time_s=0.1, data_wait_s=0.3,
         flops_per_step=5e9, peak_flops=1e12),
    dict(step=9, window_steps=1, window_time_s=0.02, samples=4,
         device_mem_bytes=123456, device_mem_peak_bytes=234567,
         flops_per_step=1e9, peak_flops=2e12),
]


@pytest.mark.parametrize("kw", _RECORDS)
def test_make_step_record_equals_the_reference(kw):
    got = monitor.make_step_record(**kw)
    want = jmonitor.make_step_record(**kw)
    assert abs(got.pop("ts") - want.pop("ts")) < 60
    assert got == want
    monitor.validate_step_record(dict(got, ts=0.0))
    jmonitor.validate_step_record(dict(got, ts=0.0))


def test_validate_rejects_what_the_reference_rejects():
    good = monitor.make_step_record(step=1, window_steps=1,
                                    window_time_s=0.1)
    for bad, key in ((dict(good, extra_key=1), "extra_key"),
                     (dict(good, data_wait_frac=1.5), "data_wait_frac"),
                     (dict(good, step="1"), "step"),
                     ({k: v for k, v in good.items() if k != "ts"}, "ts")):
        for mod in (monitor, jmonitor):
            with pytest.raises(ValueError, match=key):
                mod.validate_step_record(bad)


def test_default_peak_is_the_cards():
    assert monitor._DEFAULT_PEAK_FLOPS == device_time.GPU_PEAK_FLOPS \
        == 989e12
    rec = monitor.make_step_record(step=1, window_steps=1, window_time_s=1.0,
                                   flops_per_step=989e12)
    assert rec["mfu_est"] == 1.0


class _DS(Dataset):
    def __len__(self):
        return 24

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        return (rng.normal(size=(8,)).astype(np.float32),
                np.array(i % 3, np.int64))


def test_fit_records_pass_both_validators(tmp_path):
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                              torch.nn.Linear(16, 3))
    model = Model(net)
    model.prepare(optimizer.SGD(0.1, parameters=net.parameters()),
                  F.cross_entropy)
    path = tmp_path / "steps.jsonl"
    mon = cb.ThroughputMonitor(window=2, jsonl_path=str(path),
                               samples_per_step=4, flops_per_sample=1e6,
                               peak_flops=1e12)
    watchdog.get_watchdog().reset()
    model.fit(_DS(), batch_size=4, epochs=2, verbose=0, callbacks=[mon])
    # 6 steps an epoch, window 2: three windows an epoch
    assert [r["step"] for r in mon.records] == [2, 4, 6, 8, 10, 12]
    for rec in mon.records:
        monitor.validate_step_record(rec)
        jmonitor.validate_step_record(rec)
        assert rec["window_steps"] == 2 and rec["samples"] == 8
        assert rec["mfu_est"] > 0 and rec["ips"] > 0
        # the CPU samples no device memory
        assert rec["device_mem_bytes"] is None
        assert 0.0 <= rec["data_wait_frac"] <= 1.0
    # the first step of the fit captured its one signature: no retrace
    assert [r["retraces"] for r in mon.records] == [0] * 6
    assert [json.loads(line) for line in open(path)] == mon.records
    assert len(mon.diagnoses) == 6
    assert all(d["dominant"] in monitor.DIAG_TERMS + ("unattributed",)
               for d in mon.diagnoses)
    # the fit noted its steps (liveness); the monitor left them to it
    assert server.liveness()["last_step"] == 12


def test_manual_loop_notes_steps_and_counts_retraces():
    wd = watchdog.get_watchdog()
    wd.reset()
    with server._liveness_lock:
        server._liveness.update(step=None, ts=None, wall_ts=None)
    mon = monitor.ThroughputMonitor(window=10)
    mon.on_train_begin()
    mon.on_train_batch_begin(0)
    wd.observe("s", "f", [torch.ones(2)])
    wd.observe("s", "f", [torch.ones(3)])
    mon.on_train_batch_end(0)
    mon.on_train_end()
    assert mon.records[-1]["retraces"] == 1
    assert server.liveness()["last_step"] == 1
    wd.reset()


# (cumulative seconds at the window's start and end per term, wall)
_WINDOWS = [
    ({"data_wait": 1.0, "compile": 2.0}, {"data_wait": 1.5, "compile": 2.1},
     1.0),
    ({}, {"compile": 3.0, "host_dispatch": 0.5}, 2.0),
    ({"checkpoint": 1.0}, {"checkpoint": 0.5, "data_wait": 0.2}, 0.1),
    ({}, {}, 0.0),
]


@pytest.mark.parametrize("begin,end,wall", _WINDOWS)
def test_diagnose_window_equals_the_reference(monkeypatch, begin, end,
                                              wall):
    full = {t: 0.0 for t in ("data_wait",) + tuple(monitor._DIAG_FAMILIES)}
    end = dict(full, **end)
    assert set(full) == {"data_wait"} | set(jmonitor._DIAG_FAMILIES)
    monkeypatch.setattr(monitor, "diag_signals", lambda: dict(end))
    monkeypatch.setattr(jmonitor, "diag_signals", lambda: dict(end))
    got = monitor.diagnose_window(dict(full, **begin), wall, steps=3,
                                  step=9, emit=False)
    want = jmonitor.diagnose_window(dict(full, **begin), wall, steps=3,
                                    step=9, emit=False)
    assert got == want
    assert monitor.last_diagnosis() == got


def test_diag_signals_read_the_compile_family():
    before = monitor.diag_signals()
    assert set(before) == {"data_wait"} | set(monitor._DIAG_FAMILIES)
    from paddle_tpu_torch.profiler import compile_watch
    compile_watch.record("graph_capture", 0.25)
    after = monitor.diag_signals()
    assert after["compile"] == pytest.approx(before["compile"] + 0.25)
    # the collective and barrier families move only with collectives and
    # coordinated saves, none of which ran here (another test of this
    # process may have fed them before)
    assert after["collective"] == before["collective"]
    assert after["straggler_wait"] == before["straggler_wait"]


def test_device_memory_samples_nothing_on_the_cpu():
    reg = metrics.MetricsRegistry()
    assert metrics.sample_device_memory(reg) == {}
    assert metrics.update_device_memory_gauges(reg) == {}
    assert "device_memory_bytes_in_use" not in reg.names()
    assert monitor._sampled_device_mem() == (None, None)


def test_device_memory_reads_the_allocator_on_a_card(monkeypatch):
    stats = {0: {"allocated_bytes.all.current": 1000,
                 "allocated_bytes.all.peak": 5000},
             1: {"allocated_bytes.all.current": 7,
                 "allocated_bytes.all.peak": 9}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats[i])
    reg = metrics.MetricsRegistry()
    sample = metrics.update_device_memory_gauges(reg)
    assert sample == {
        "cuda:0": {"bytes_in_use": 1000, "peak_bytes": 5000,
                   "src": "memory_stats"},
        "cuda:1": {"bytes_in_use": 7, "peak_bytes": 9,
                   "src": "memory_stats"}}
    assert reg.get("device_memory_peak_bytes").value(device="cuda:0") == 5000
    assert reg.get("device_bytes_in_use").value(device="cuda:1") == 7
    assert reg.get("device_peak_bytes_in_use").value(device="cuda:1") == 9
    metrics.set_enabled(False)
    try:
        assert metrics.update_device_memory_gauges(
            metrics.MetricsRegistry()) == {}
    finally:
        metrics.set_enabled(True)
    monkeypatch.setattr(metrics, "_default_registry", reg)
    assert monitor._sampled_device_mem() == (1007, 5009)
