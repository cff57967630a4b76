"""Throughput timer (ips) — reference `python/paddle/profiler/timer.py`.

A copy of ``paddle_tpu/profiler/timer.py`` with its degradation contract.

`Benchmark` tracks reader (data-wait) cost vs batch cost with moving averages
and reports instantaneous + summary ips, exactly the shape of the reference's
`Benchmark:325` / `benchmark():417` speed reporter that hapi and the
DataLoader hook into.

Degradation contract (audited): every accessor is safe with zero recorded
steps, zero recorded samples (`num_samples=None` throughout), a `step()`
stream that never saw a reader fetch, and `end()` without `begin()` — ips
degrades to 0.0 / falls back to steps/s, never ZeroDivisionError.
"""
from __future__ import annotations

import time
from typing import Optional


class TimeAverager:
    """Reference `timer.py:278`."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._total = 0.0
        self._cnt = 0
        self._total_samples = 0

    def record(self, usetime: float, num_samples: Optional[int] = None):
        self._total += usetime
        self._cnt += 1
        if num_samples:
            self._total_samples += num_samples

    @property
    def total_time(self) -> float:
        return self._total

    @property
    def count(self) -> int:
        return self._cnt

    @property
    def total_samples(self) -> int:
        return self._total_samples

    def get_average(self) -> float:
        return self._total / self._cnt if self._cnt else 0.0

    def get_ips_average(self) -> float:
        return self._total_samples / self._total if self._total else 0.0


class Benchmark:
    """Reference `timer.py:325`."""

    def __init__(self):
        self.reader = TimeAverager()
        self.batch = TimeAverager()
        self._step_start = None
        self._reader_start = None
        self.total_samples = 0
        self.total_time = 0.0
        self._begin_time = None

    def reset(self):
        """Zero both averagers and the run totals (window restart)."""
        self.reader.reset()
        self.batch.reset()
        self._step_start = None
        self._reader_start = None
        self.total_samples = 0
        self.total_time = 0.0
        self._begin_time = None

    # DataLoader hook: called around the fetch of each batch
    def before_reader(self):
        self._reader_start = time.perf_counter()

    def after_reader(self):
        if self._reader_start is not None:
            self.reader.record(time.perf_counter() - self._reader_start)
            self._reader_start = None

    def begin(self):
        self._begin_time = time.perf_counter()
        self._step_start = time.perf_counter()

    def step(self, num_samples: Optional[int] = None):
        """Close one step window. Works without a prior `begin()` (the first
        call then only arms the timer — there is no window to record yet)."""
        now = time.perf_counter()
        if self._step_start is not None:
            self.batch.record(now - self._step_start, num_samples)
            if num_samples:
                self.total_samples += num_samples
        self._step_start = now

    def end(self):
        if self._begin_time is not None:
            self.total_time = time.perf_counter() - self._begin_time

    def step_info(self, unit: str = "samples") -> str:
        batch_avg = self.batch.get_average()
        reader_avg = self.reader.get_average()
        ips = self.batch.get_ips_average()
        msg = (f"reader_cost: {reader_avg:.5f} s, batch_cost: {batch_avg:.5f} s")
        if ips:
            msg += f", ips: {ips:.2f} {unit}/s"
        elif batch_avg:
            # no sample counts ever recorded: steps/s is still meaningful
            msg += f", ips: {1.0 / batch_avg:.2f} steps/s"
        return msg

    def report(self) -> dict:
        batch_avg = self.batch.get_average()
        return {
            "reader_cost_avg_s": self.reader.get_average(),
            "batch_cost_avg_s": batch_avg,
            "ips": self.batch.get_ips_average(),
            "steps_per_sec": 1.0 / batch_avg if batch_avg else 0.0,
            "total_samples": self.total_samples,
            "total_time_s": self.total_time,
        }


_benchmark = Benchmark()


def benchmark() -> Benchmark:
    """Global speed reporter (reference `timer.py:417`)."""
    return _benchmark
