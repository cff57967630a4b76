#!/usr/bin/env python3
"""Where the time goes in one training step of the PyTorch/H100 port.

    python3 tools/profile_torch_train.py          # from the repository root
    python3 tools/profile_torch_train.py --long   # B 1 x 32,768, remat "full"

Builds GPT-2 small at full width (random weights from seed 0, dropout 0)
and trains it with ``paddle_tpu_torch.jit.TrainStep(model, F.cross_entropy,
AdamW(lr=1e-4, weight_decay=0.01), amp_dtype=torch.bfloat16)`` at batch 8,
sequence 1024 on one card (the JAX package's ``bench_gpt2`` configuration),
or with ``--long`` on one 32,768-token sequence (max_position_embeddings
32,768) with ``GPTConfig.remat = "full"``, whose attention backward is the
split dq / dk-dv pair. After the warm-up steps (two; one with ``--long``)
it measures, with ``torch.profiler`` (CPU and CUDA activities), a window
of steps (three; one with ``--long``, a step of seconds):

* host wall time per step, device busy time (the sum of device-side event
  times on the one stream) and the idle share 1 - busy / wall;
* device time per group: each hand-written kernel, the matrix products
  (cuBLAS), the multi-tensor optimizer update, other elementwise and
  reduction kernels, copies and fills;
* the matrix products by kernel name, and the top kernels overall;
* each hand-written kernel's launches per step (its wrapper's counter);

and the same window without the profiler, for its overhead. Writes
``chiprun_out/profile_torch_train.json`` (``profile_torch_train_long.json``
with ``--long``). Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from paddle_tpu_torch import optimizer  # noqa: E402
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.models.gpt import GPT, GPTConfig  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.ops import kernels  # noqa: E402

#: (batch, sequence, remat, warm-up steps, profiled steps) of each run
RUNS = {"b8s1024": (8, 1024, "", 2, 3), "long": (1, 32768, "full", 1, 1)}

#: device-kernel name fragments -> group (first match wins)
GROUPS = (
    ("flash_attention_bwd_dq", ("flash_bwd_dq_",)),
    ("flash_attention_bwd_dkv", ("flash_bwd_dkv_",)),
    ("flash_attention_bwd", ("flash_bwd_kernel", "flash_bwd_tc_kernel")),
    ("flash_attention", ("flash_fwd_",)),
    ("layer_norm", ("layer_norm_fwd_kernel",)),
    ("softmax_ce_fwd", ("ce_fwd_kernel",)),
    ("softmax_ce_bwd", ("ce_bwd_kernel",)),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("optimizer (multi-tensor)", ("multi_tensor_apply",)),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("copy/fill", ("memcpy", "memset", "copy", "fill")),
)


def _group(name: str, groups=GROUPS) -> str:
    low = name.lower()
    for group, keys in groups:
        if any(k in low for k in keys):
            return group
    return "other"


def _device_summary(prof, wall_s, n_steps, groups=GROUPS):
    """Sums over the device-side events only (the CPU ops that launched
    them carry the same time and are skipped, so nothing counts twice).
    One stream, so the sum is the busy time. ``groups``: (group, name
    fragments) pairs, the first match wins."""
    by_name = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    busy_us = sum(t for t, _ in by_name.values())
    by_group = {}
    for k, (t, c) in by_name.items():
        g = by_group.setdefault(_group(k, groups), [0.0, 0])
        g[0] += t
        g[1] += c
    per = max(1, n_steps)
    rows = sorted(((t, k, c) for k, (t, c) in by_name.items()), reverse=True)
    gemms = [r for r in rows if _group(r[1], groups) == "gemm"]
    return dict(
        wall_ms=wall_s * 1e3 / per,
        device_busy_ms=busy_us / 1e3 / per if by_name else None,
        idle_share=1.0 - busy_us / 1e6 / wall_s if by_name else None,
        device_ops_per_step=sum(c for _, c in by_name.values()) / per,
        groups={g: dict(device_ms=t / 1e3 / per, calls=c / per,
                        share=t / busy_us)
                for g, (t, c) in sorted(by_group.items(),
                                        key=lambda kv: -kv[1][0])},
        gemm_kernels=[dict(name=k[:100], device_ms=t / 1e3 / per,
                           calls=c / per) for t, k, c in gemms[:10]],
        top=[dict(name=k[:100], device_ms=t / 1e3 / per, calls=c / per)
             for t, k, c in rows[:15]])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--long", action="store_true",
                    help="B 1 x 32,768 tokens with remat 'full'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA card", file=sys.stderr)
        return 2
    run = "long" if args.long else "b8s1024"
    B, L, remat, warmup, window = RUNS[run]
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = GPTConfig.gpt2_small()
    cfg.dropout = cfg.attn_dropout = 0.0
    cfg.max_position_embeddings = max(L, cfg.max_position_embeddings)
    cfg.remat = remat
    model = GPT(cfg, device="cuda",
                generator=torch.Generator().manual_seed(0))
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                          weight_decay=0.01)
    step = TrainStep(model, F.cross_entropy, opt, amp_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, L))).cuda()
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, L))).cuda()
    for _ in range(warmup):
        step(ids, labels)
    torch.cuda.synchronize()

    act = torch.profiler.ProfilerActivity
    kernels.reset_stats()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(window):
            loss = step(ids, labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = _device_summary(prof, wall, window)
    out["launches_per_step"] = {k: v["kernel"] / window
                                for k, v in kernels.all_stats().items()}
    out["plain_runs"] = {k: v["plain"] for k, v in
                         kernels.all_stats().items()}

    t0 = time.perf_counter()
    for _ in range(window):
        loss = step(ids, labels)
    torch.cuda.synchronize()
    out["wall_ms_unprofiled"] = (time.perf_counter() - t0) * 1e3 / window
    out["loss"] = float(loss)
    out.update(card=smi, batch=B, seq=L, remat=remat, window=window,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    os.makedirs("chiprun_out", exist_ok=True)
    name = "_long" if args.long else ""
    with open(f"chiprun_out/profile_torch_train{name}.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
