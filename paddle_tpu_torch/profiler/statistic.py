"""Span aggregation + text report.

A copy of ``paddle_tpu/profiler/statistic.py``: the text table is the
reference's, character for character, on the same spans.

Reference parity: `python/paddle/profiler/profiler_statistic.py` (SortedKeys,
StatisticData, per-event-type and per-name tables with count/total/avg/max/min
and ratio columns).
"""
from __future__ import annotations

from enum import Enum
from typing import Dict, List, Optional

from .recorder import HostSpan


class SortedKeys(Enum):
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    Calls = 4


class _Item:
    __slots__ = ("name", "calls", "total_ns", "max_ns", "min_ns",
                 "device_ns", "device_src")

    def __init__(self, name):
        self.name = name
        self.calls = 0
        self.total_ns = 0
        self.max_ns = 0
        self.min_ns = None
        self.device_ns = 0       # summed device-side time (0 = none seen)
        self.device_src = None   # "measured" | "estimate" | None

    def add(self, span: HostSpan):
        d = span.dur_ns
        self.calls += 1
        self.total_ns += d
        self.max_ns = max(self.max_ns, d)
        self.min_ns = d if self.min_ns is None else min(self.min_ns, d)
        if span.device_ns is not None:
            self.device_ns += span.device_ns
            # the best span upgrades the row's provenance label
            # (estimate < measured < xplane — device_time.SRC_PRIORITY)
            from .device_time import SRC_PRIORITY
            if SRC_PRIORITY.get(span.device_src, 0) \
                    > SRC_PRIORITY.get(self.device_src, -1):
                self.device_src = span.device_src

    @property
    def avg_ns(self):
        return self.total_ns / self.calls if self.calls else 0


class StatisticData:
    """Aggregates host spans by name and event type."""

    def __init__(self, spans: List[HostSpan]):
        self.spans = spans
        self.by_name: Dict[str, _Item] = {}
        self.by_type: Dict[str, _Item] = {}
        for s in spans:
            self.by_name.setdefault(s.name, _Item(s.name)).add(s)
            self.by_type.setdefault(s.event_type, _Item(s.event_type)).add(s)
        if spans:
            self.wall_ns = (max(s.end_ns for s in spans)
                            - min(s.start_ns for s in spans))
        else:
            self.wall_ns = 0


_SORT_ATTR = {
    SortedKeys.CPUTotal: "total_ns",
    SortedKeys.CPUAvg: "avg_ns",
    SortedKeys.CPUMax: "max_ns",
    SortedKeys.CPUMin: "min_ns",
    SortedKeys.Calls: "calls",
}


def _fmt(ns: float, unit: str) -> str:
    div = {"s": 1e9, "ms": 1e6, "us": 1e3, "ns": 1.0}[unit]
    return f"{ns / div:.3f}"


def summary_report(data: StatisticData, sorted_by: Optional[SortedKeys] = None,
                   time_unit: str = "ms") -> str:
    sorted_by = sorted_by or SortedKeys.CPUTotal
    attr = _SORT_ATTR[sorted_by]
    rows = sorted(data.by_name.values(),
                  key=lambda it: getattr(it, attr) or 0, reverse=True)
    name_w = max([len(r.name) for r in rows], default=4)
    name_w = max(name_w, 4)
    # the device column appears only when spans carried device attribution
    # (host time = dispatch latency; device time = execution, measured or
    # roofline-estimated — see profiler/device_time.py)
    has_device = any(r.device_ns for r in rows)
    header = (f"{'Name':<{name_w}}  {'Calls':>7}  {'Total(' + time_unit + ')':>12}  "
              f"{'Avg(' + time_unit + ')':>12}  {'Max(' + time_unit + ')':>12}  "
              f"{'Min(' + time_unit + ')':>12}  {'Ratio(%)':>8}")
    if has_device:
        header += f"  {'Dev(' + time_unit + ')':>12}  {'DevSrc':>8}"
    lines = ["-" * len(header), header, "-" * len(header)]
    total = sum(r.total_ns for r in rows) or 1
    for r in rows:
        line = (
            f"{r.name:<{name_w}}  {r.calls:>7}  {_fmt(r.total_ns, time_unit):>12}  "
            f"{_fmt(r.avg_ns, time_unit):>12}  {_fmt(r.max_ns, time_unit):>12}  "
            f"{_fmt(r.min_ns or 0, time_unit):>12}  {100 * r.total_ns / total:>8.2f}")
        if has_device:
            line += (f"  {_fmt(r.device_ns, time_unit):>12}  "
                     f"{r.device_src or '-':>8}")
        lines.append(line)
    lines.append("-" * len(header))
    lines.append(f"Wall clock: {_fmt(data.wall_ns, time_unit)} {time_unit}; "
                 f"{len(data.spans)} spans, {len(data.by_name)} distinct names")
    return "\n".join(lines)
