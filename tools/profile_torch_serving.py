#!/usr/bin/env python3
"""Where the time goes in the PyTorch/H100 port's GPT-2 small serving path.

    python3 tools/profile_torch_serving.py     # from the repository root

Builds GPT-2 small at full width (fp32, random weights from seed 0) under
``paddle_tpu_torch.inference.ServingEngine(max_batch=32, max_len=1024,
page_size=16)`` on one card and measures, with ``torch.profiler`` (CPU and
CUDA activities):

* one prefill of a 960-token prompt (the 1024 bucket);
* a steady window of decode iterations with all 32 lanes active;

For each: host wall time, device busy time (the sum of kernel times on the
one stream), the idle share 1 - busy / wall, the paged attention kernels'
device time and share of busy, the top kernels by device
time, and each hand-written kernel's launches (from the wrappers'
counters). Writes ``chiprun_out/profile_torch_serving.json``. Needs a card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from paddle_tpu_torch.inference.serving import ServingEngine  # noqa: E402
from paddle_tpu_torch.models.gpt import GPT, GPTConfig  # noqa: E402
from paddle_tpu_torch.ops import kernels  # noqa: E402

DECODE_WINDOW = 10


def _device_summary(prof, wall_s, n_iters):
    """Sums over the device-side events only (kernels, copies, fills):
    the CPU ops that launched them carry the same time and are skipped,
    so nothing counts twice. One stream, so the sum is the busy time."""
    by_name = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    busy_us = sum(t for t, _ in by_name.values())
    n_ops = sum(c for _, c in by_name.values())
    rows = sorted(((t, k, c) for k, (t, c) in by_name.items()),
                  reverse=True)
    per = max(1, n_iters)
    paged_us = sum(t for k, (t, _) in by_name.items() if "paged_attn" in k)
    return dict(
        wall_ms=wall_s * 1e3 / per,
        device_busy_ms=(busy_us / 1e3 / per) if n_ops else None,
        idle_share=(1.0 - busy_us / 1e6 / wall_s) if n_ops else None,
        device_ops_per_iteration=n_ops / per,
        paged_attention_ms=paged_us / 1e3 / per,
        paged_attention_share=(paged_us / busy_us) if n_ops else None,
        top=[dict(name=k[:90], device_ms=t / 1e3 / per, calls=c / per)
             for t, k, c in rows[:12]])


def main():
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = GPTConfig.gpt2_small()
    cfg.dropout = cfg.attn_dropout = 0.0
    model = GPT(cfg, device="cuda",
                generator=torch.Generator().manual_seed(0))
    eng = ServingEngine(model, max_batch=32, max_len=1024, page_size=16)
    rng = np.random.default_rng(0)
    act = torch.profiler.ProfilerActivity

    # warm-up: every code path once (cuBLAS handles, allocator)
    eng.generate(rng.integers(1, cfg.vocab_size, 40).tolist(), 4)

    # one 1024-bucket prefill (a single request, so step() admits it)
    long_prompt = rng.integers(1, cfg.vocab_size, 960).tolist()
    req = eng.submit(long_prompt, max_new_tokens=1)
    kernels.reset_stats()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        eng._admit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    assert req.state == "done"
    prefill = _device_summary(prof, wall, 1)
    prefill["launches"] = kernels.all_stats()

    # steady decode: 32 lanes active
    reqs = [eng.submit(rng.integers(1, cfg.vocab_size,
                                    int(rng.integers(32, 513))).tolist(),
                       max_new_tokens=64) for _ in range(32)]
    eng.step()                   # admits all 32 and decodes once
    for _ in range(3):
        eng.step()
    kernels.reset_stats()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(DECODE_WINDOW):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    decode = _device_summary(prof, wall, DECODE_WINDOW)
    decode["launches_per_iteration"] = {
        k: v["kernel"] / DECODE_WINDOW for k, v in kernels.all_stats().items()}
    decode["active_lanes"] = sum(r.state == "running" for r in reqs)

    # the same window without the profiler, for its overhead
    t0 = time.perf_counter()
    for _ in range(DECODE_WINDOW):
        eng.step()
    torch.cuda.synchronize()
    decode["wall_ms_unprofiled"] = (time.perf_counter() - t0) * 1e3 \
        / DECODE_WINDOW
    eng.close()

    out = dict(card=smi, prefill_960=prefill, decode_w32=decode)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/profile_torch_serving.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
