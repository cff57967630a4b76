#!/usr/bin/env python3
"""Where the time goes in the PyTorch/H100 port's parameter-server path.

    python3 tools/profile_torch_ps.py        # from the repository root

Wide&Deep at bench.py's widths (chip_smoke.py phase 25: B 512, 8 slots,
ids in [0, 1,000,000), dim 16, 13 dense features, hidden 64, Adam 1e-3,
server SGD 0.05, 8 seeded batches reused in turn), each mode on a fresh
table server, on one card:

* the eager loop, sync ``HeterPSTrainStep`` and the pipelined step with the
  32,768-row hot-row cache and prefetch (after two warm-up passes), each
  under ``cProfile`` on the main thread: wall ms a step, the stage totals
  a step (route, plan, pull, h2d, dispatch, push), and the functions with
  the most own time;
* ``torch.profiler`` (CPU and CUDA activities) over 5 sync and 5 pipelined
  steps: device busy ms a step (the sum of kernel and memcpy times), the
  idle share 1 - busy / wall, and the top device operations.

Writes ``chiprun_out/profile_torch_ps.json`` under the directory it is
started from, and prints a summary. Needs a card.
"""
from __future__ import annotations

import cProfile
import io
import json
import os
import pstats
import sys
import time

import torch

STEPS = 12


def top_functions(prof: cProfile.Profile, n: int = 18) -> list:
    """The ``n`` functions with the most own time: (where, calls, own ms,
    cumulative ms)."""
    st = pstats.Stats(prof, stream=io.StringIO())
    rows = []
    for (file, line, name), (_, calls, tt, ct, _) in st.stats.items():
        rows.append((f"{os.path.basename(file)}:{line}:{name}", calls,
                     1000 * tt, 1000 * ct))
    rows.sort(key=lambda r: -r[2])
    return [dict(where=w, calls=c, own_ms=t, cum_ms=ct)
            for w, c, t, ct in rows[:n]]


def device_window(step, data, steps: int, prefetch: bool) -> dict:
    """torch.profiler over ``steps`` steps: wall, device busy and the top
    device operations by time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            step(*data[i % len(data)])
            if prefetch and i + 1 < steps:
                step.prefetch(*data[(i + 1) % len(data)])
        step.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, ops = 0.0, []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0))
        if dev > 0:
            busy_us += dev
            ops.append((e.key, e.count, dev))
    ops.sort(key=lambda r: -r[2])
    return dict(wall_ms=1000 * wall / steps, busy_ms=busy_us / 1000 / steps,
                idle_share=1 - busy_us / 1e6 / wall,
                top_device_ops=[dict(name=k[:80], count=c, ms=t / 1000)
                                for k, c, t in ops[:12]])


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_ps: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from paddle_tpu_torch import nn, optimizer

    smi = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    data = cs.ps_data(0)
    out = {"card": smi, "steps": STEPS}

    # the eager loop
    with cs.ps_client() as client:
        model = cs.ps_model(client, "cuda")
        opt = optimizer.Adam(learning_rate=1e-3,
                             parameters=model.parameters())
        crit = nn.BCEWithLogitsLoss()

        def eager(b):
            ids, dense, labels = b
            loss = crit(model(ids, dense.cuda()), labels.cuda())
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.item()

        for b in data[:2]:
            eager(b)
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        for i in range(STEPS):
            eager(data[i % len(data)])
        prof.disable()
        out["eager"] = dict(wall_ms=1000 * (time.perf_counter() - t0)
                            / STEPS, top=top_functions(prof))

    for mode, cache in (("sync", 0), ("pipelined", cs.PS_CACHE)):
        with cs.ps_client() as client:
            step = cs.ps_heter(cs.ps_model(client, "cuda"), mode, cache)
            try:
                warm = data + data if cache else data[:2]
                for b in warm:
                    step(*b)
                step.flush()
                for k in step.stage_totals:
                    step.stage_totals[k] = 0 if k == "steps" else 0.0
                prof = cProfile.Profile()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prof.enable()
                for i in range(STEPS):
                    step(*data[i % len(data)])
                    if cache and i + 1 < STEPS:
                        step.prefetch(*data[(i + 1) % len(data)])
                step.flush()
                torch.cuda.synchronize()
                prof.disable()
                wall = time.perf_counter() - t0
                n = max(step.stage_totals["steps"], 1)
                res = dict(wall_ms=1000 * wall / STEPS, stages_ms={
                    k[:-2]: 1000 * v / n
                    for k, v in step.stage_totals.items()
                    if k.endswith("_s")}, top=top_functions(prof))
                res["device"] = device_window(step, data, 5, bool(cache))
                out[mode] = res
            finally:
                step.close()

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_torch_ps.json"), "w") as f:
        json.dump(out, f, indent=1)
    for key in ("eager", "sync", "pipelined"):
        r = out[key]
        line = f"{key}: {r['wall_ms']:.3f} ms a step"
        if "stages_ms" in r:
            line += " (" + ", ".join(f"{k} {v:.3f}"
                                     for k, v in r["stages_ms"].items()) + ")"
        if "device" in r:
            d = r["device"]
            line += (f"; profiled {d['wall_ms']:.3f} ms, device busy "
                     f"{d['busy_ms']:.3f} ms, idle {d['idle_share']:.3f}")
        print(f"{line} [{smi}]")
        for t in r["top"][:10]:
            print(f"    {t['own_ms'] / STEPS:8.3f} own ms/step "
                  f"{t['cum_ms'] / STEPS:8.3f} cum  {t['calls']:6d}  "
                  f"{t['where']}")
        for t in r.get("device", {}).get("top_device_ops", [])[:6]:
            print(f"    device {t['ms'] / 5:8.4f} ms/step x{t['count']} "
                  f"{t['name']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
