"""Per-op device-time attribution for host spans (counterpart of
``paddle_tpu/profiler/device_time.py``).

A host span measures the HOST's time (a launch, a graph replay's
enqueue), not the card's: a CUDA launch returns in microseconds while its
kernels run for milliseconds, so host spans alone cannot separate
"launch-bound" from "device-bound". Two attribution modes, recorded
alongside each span:

* ``estimate`` (default, works everywhere incl. the CPU tests): a roofline
  bound — max(flops / peak_flops, bytes / peak_bw) for the span's work.
  Clearly labeled an ESTIMATE.
* ``measured`` (`PADDLE_TPU_DEVICE_TIME=sync`): ``torch.cuda.synchronize()``
  after the traced work, so the span's device time is the wall until the
  card is done. This SERIALIZES the launch pipeline — a profiling mode,
  never the default.

The full-fidelity third mode lives in `profiler/xplane.py`: a bounded
``torch.profiler`` (Kineto) capture whose trace is correlated back onto
host spans (``device_src="xplane"``).

Peaks: on a card the H100's own, 989e12 FLOP/s (bf16 dense) and
3.35e12 B/s (HBM3), overridden by `BENCH_PEAK_FLOPS` (FLOP/s) and
`PADDLE_TPU_PEAK_HBM_GBS` (GB/s); the CPU gets deliberately synthetic
defaults (100 GFLOP/s, 20 GB/s) so estimate rows stay obviously synthetic
there.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import torch

from ..utils.envparse import env_float

__all__ = ["sync_mode", "estimate_ns", "attribute", "split_rows",
           "platform_peaks", "reset_peaks", "GPU_PEAK_FLOPS", "GPU_PEAK_BW"]

_CPU_PEAK_FLOPS = 100e9
_CPU_PEAK_BW = 20e9
#: NVIDIA H100 SXM: dense bf16 tensor-core peak and HBM3 bandwidth
GPU_PEAK_FLOPS = 989e12
GPU_PEAK_BW = 3.35e12

# cache keyed on the env knobs that feed it — a test or bench changing
# BENCH_PEAK_FLOPS / PADDLE_TPU_PEAK_HBM_GBS mid-process must see fresh
# peaks, not the first call's (the platform probe alone stays cached: a
# process cannot change backends)
_peaks_cache: Optional[Tuple[Tuple[Optional[str], Optional[str]],
                             Tuple[str, float, float]]] = None


def _platform() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def platform_peaks() -> Tuple[str, float, float]:
    """(platform, peak_flops/s, peak_bytes/s) used by the estimator."""
    global _peaks_cache
    env_key = (os.environ.get("BENCH_PEAK_FLOPS"),
               os.environ.get("PADDLE_TPU_PEAK_HBM_GBS"))
    if _peaks_cache is not None and _peaks_cache[0] == env_key:
        return _peaks_cache[1]
    plat = _platform() if _peaks_cache is None else _peaks_cache[1][0]
    if plat == "cpu":
        peaks = (plat, _CPU_PEAK_FLOPS, _CPU_PEAK_BW)
    else:
        flops = float(env_key[0]) if env_key[0] else GPU_PEAK_FLOPS
        bw = env_float("PADDLE_TPU_PEAK_HBM_GBS", GPU_PEAK_BW / 1e9) * 1e9
        peaks = (plat, flops, bw)
    _peaks_cache = (env_key, peaks)
    return peaks


def reset_peaks():
    """Drop the cached peaks (including the platform probe) — tests that
    monkeypatch the backend need this; env-knob changes are picked up
    automatically."""
    global _peaks_cache
    _peaks_cache = None


def sync_mode() -> bool:
    """True when PADDLE_TPU_DEVICE_TIME=sync: measure completion instead of
    estimating (serializes the launches — profiling runs only)."""
    return os.environ.get("PADDLE_TPU_DEVICE_TIME", "").lower() == "sync"


def estimate_ns(flops: float, nbytes: float) -> int:
    """Roofline device-time estimate in ns: the work is bound by compute or
    memory, whichever is slower at the platform's peaks."""
    _, peak_flops, peak_bw = platform_peaks()
    sec = max((flops or 0.0) / peak_flops, (nbytes or 0.0) / peak_bw)
    return int(sec * 1e9)


def _on_card(outs) -> bool:
    if isinstance(outs, torch.Tensor):
        return outs.is_cuda
    if isinstance(outs, (list, tuple)):
        return any(_on_card(o) for o in outs)
    if isinstance(outs, dict):
        return any(_on_card(o) for o in outs.values())
    return False


def attribute(outs, flops: float, nbytes: float,
              start_ns: int) -> Tuple[int, str]:
    """(device_ns, source) for one traced piece of work. In sync mode, waits
    for the card (when ``outs`` holds a CUDA tensor) and reports
    wall-until-completion as "measured"; otherwise returns the roofline
    "estimate"."""
    if sync_mode():
        from .recorder import now_ns
        if _on_card(outs):
            torch.cuda.synchronize()
        return max(0, now_ns() - start_ns), "measured"
    return estimate_ns(flops, nbytes), "estimate"


#: provenance ranking: a row's src label is its best span's source
#: (xplane = correlated from a real device trace, the authoritative
#: mode; measured = sync-mode wall; estimate = roofline bound)
SRC_PRIORITY = {"estimate": 0, "measured": 1, "xplane": 2}


def split_rows(spans) -> List[dict]:
    """Aggregate host-vs-device time per op name from spans that carry
    device attribution, sorted by device time desc."""
    acc: Dict[str, dict] = {}
    for s in spans:
        if getattr(s, "device_ns", None) is None:
            continue
        row = acc.setdefault(s.name, {"op": s.name, "calls": 0,
                                      "host_ms": 0.0, "device_ms": 0.0,
                                      "src": s.device_src or "estimate"})
        row["calls"] += 1
        row["host_ms"] += s.dur_ns / 1e6
        row["device_ms"] += s.device_ns / 1e6
        if SRC_PRIORITY.get(s.device_src, 0) > SRC_PRIORITY.get(row["src"], 0):
            row["src"] = s.device_src
    rows = sorted(acc.values(), key=lambda r: -r["device_ms"])
    for r in rows:
        r["host_ms"] = round(r["host_ms"], 4)
        r["device_ms"] = round(r["device_ms"], 4)
    return rows
