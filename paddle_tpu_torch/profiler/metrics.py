"""Labeled metrics registry: Counter / Gauge / Histogram with Prometheus
text and JSON-snapshot exporters (a copy of ``paddle_tpu/profiler/
metrics.py`` without its JAX device-memory sampling).

The runtime's quantitative observability spine (complementing the span-based
host tracer in `recorder.py`): op dispatch counts/bytes, jit-cache and
retrace counters, collective bytes by link class (ICI vs DCN), DataLoader
wait time, and device-memory gauges all land here. The reference stack
scatters these over VisualDL scalars and ad-hoc `stat.h` registries
(`paddle/fluid/platform/monitor.h` `Monitor`/`StatRegistry`); on TPU a
single process-wide registry with a `/metrics`-style text dump is the more
useful shape (scrapeable, snapshot-able into bench JSON).

Enable/disable: metrics are ON by default; set `PADDLE_TPU_METRICS=0` (or
call `set_enabled(False)`) to make every instrumentation site skip its
recording. Instrument sites MUST check `metrics.enabled()` so the disabled
path costs one module-attr read.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "enabled", "set_enabled",
]

# default histogram buckets: seconds, spanning sub-ms host dispatch to
# multi-second straggler steps
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_PROM_PREFIX = "paddle_tpu_"


def _label_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _prom_escape(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _prom_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{_prom_escape(v)}"' for k, v in key) + "}"


class Metric:
    """Base: a named family of label->value series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[Tuple[Tuple[str, str], ...], object] = {}

    def clear(self):
        with self._lock:
            self._series.clear()

    def _snapshot_values(self) -> List[dict]:
        with self._lock:
            return [{"labels": dict(k), "value": v}
                    for k, v in self._series.items()]

    def snapshot(self) -> dict:
        return {"kind": self.kind, "help": self.help,
                "values": self._snapshot_values()}


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels):
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        k = _label_key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + value

    def value(self, **labels) -> float:
        return float(self._series.get(_label_key(labels), 0.0))

    def total(self) -> float:
        with self._lock:
            return float(sum(self._series.values()))


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, **labels):
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels):
        k = _label_key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + value

    def dec(self, value: float = 1.0, **labels):
        self.inc(-value, **labels)

    def value(self, **labels) -> float:
        return float(self._series.get(_label_key(labels), 0.0))


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +inf bucket last
        self.sum = 0.0
        self.count = 0


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def observe(self, value: float, **labels):
        k = _label_key(labels)
        with self._lock:
            s = self._series.get(k)
            if s is None:
                s = self._series[k] = _HistSeries(len(self.buckets))
            i = 0
            for i, b in enumerate(self.buckets):
                if value <= b:
                    break
            else:
                i = len(self.buckets)
            s.counts[i] += 1
            s.sum += value
            s.count += 1

    def _snapshot_values(self) -> List[dict]:
        out = []
        with self._lock:
            for k, s in self._series.items():
                cum, buckets = 0, {}
                for b, c in zip(self.buckets, s.counts):
                    cum += c
                    buckets[repr(b)] = cum
                buckets["+Inf"] = s.count
                out.append({"labels": dict(k), "buckets": buckets,
                            "sum": s.sum, "count": s.count})
        return out


class MetricsRegistry:
    """Process-wide named-metric registry; creation is get-or-create."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "Dict[str, Metric]" = {}

    def _get_or_create(self, cls, name: str, help: str, **kw) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif type(m) is not cls:
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def reset(self):
        """Zero every series (metric families stay registered)."""
        for m in list(self._metrics.values()):
            m.clear()

    # -- exporters -----------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-serializable {name: {kind, help, values}} snapshot."""
        return {name: self._metrics[name].snapshot()
                for name in self.names()}

    def to_prometheus_text(self) -> str:
        """Prometheus exposition text. Every registered family gets its
        HELP/TYPE header even with no series yet (so scrapers and tests see
        the full metric surface)."""
        lines = []
        for name in self.names():
            m = self._metrics[name]
            full = _PROM_PREFIX + name
            lines.append(f"# HELP {full} {m.help}")
            lines.append(f"# TYPE {full} {m.kind if m.kind != 'untyped' else 'gauge'}")
            if isinstance(m, Histogram):
                for v in m._snapshot_values():
                    base = _label_key(v["labels"])
                    for le, c in v["buckets"].items():
                        k = base + (("le", le),)
                        lines.append(f"{full}_bucket{_prom_labels(k)} {c}")
                    lines.append(f"{full}_sum{_prom_labels(base)} {v['sum']}")
                    lines.append(f"{full}_count{_prom_labels(base)} {v['count']}")
            else:
                for v in m._snapshot_values():
                    k = _label_key(v["labels"])
                    lines.append(f"{full}{_prom_labels(k)} {v['value']}")
        return "\n".join(lines) + "\n"


_default_registry = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default_registry


_enabled = os.environ.get("PADDLE_TPU_METRICS", "1").lower() not in (
    "0", "false", "off", "no")


def enabled() -> bool:
    return _enabled


def set_enabled(flag: bool):
    global _enabled
    _enabled = bool(flag)
