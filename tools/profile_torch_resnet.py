#!/usr/bin/env python3
"""Where the time goes in one ResNet-50 training step of the PyTorch/H100
port.

    python3 tools/profile_torch_resnet.py     # from the repository root

Builds ResNet-50 (NHWC, fused BN, fused 1x1 conv + BN, 1000 classes,
random weights from seed 0) and trains it with
``paddle_tpu_torch.jit.TrainStep(model, F.cross_entropy, Momentum(0.1,
0.9), amp_dtype=torch.bfloat16)`` at batch 128, 224x224 on one card (the
JAX package's ``bench_resnet50`` configuration, NHWC without remat). After
two warm-up steps it measures, with ``torch.profiler`` (CPU and CUDA
activities), a window of steps:

* host wall time per step, device busy time (the sum of device-side event
  times on the one stream) and the idle share 1 - busy / wall;
* device time per group: the cuDNN convolutions (3x3, 7x7, strided and
  the downsample 1x1s, forward and backward), the 1x1 conv + statistics
  kernel and its column-sum pass, the fused-BN kernels (the reduce with
  its column-sum pass), the softmax-CE kernels, the matrix
  products (the 1x1 chain's dx and dw), pooling, the optimizer's
  multi-tensor update, other elementwise and reduction kernels, copies;
* the top kernels, and each hand-written kernel's launches per step;

and the same window without the profiler, for its overhead. Writes
``chiprun_out/profile_torch_resnet.json``. Needs a card.
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

from paddle_tpu_torch import optimizer  # noqa: E402
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.models.resnet import resnet50  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.ops import kernels  # noqa: E402
from profile_torch_train import _device_summary  # noqa: E402

B, HW = 128, 224
WARMUP, WINDOW = 2, 3

#: device-kernel name fragments -> group (first match wins)
GROUPS = (
    # each kernel's second pass, column_sums_kernel<tag>, goes with it
    ("conv1x1 + stats (kernel)", ("conv1x1_bf16_kernel",
                                  "conv1x1_f32_kernel", "conv1x1_sums")),
    ("fused BN forward (kernel)", ("bn_fwd_kernel",)),
    ("fused BN reduce (kernel)", ("bn_reduce_kernel", "bn_reduce_sums")),
    ("fused BN dx (kernel)", ("bn_dx_kernel",)),
    ("softmax CE (kernels)", ("ce_fwd_kernel", "ce_bwd_kernel")),
    ("conv (cuDNN)", ("fprop", "dgrad", "wgrad", "conv", "cudnn",
                      "implicit", "nchwtonhwc", "nhwctonchw")),
    ("pooling", ("pool",)),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("optimizer (multi-tensor)", ("multi_tensor_apply",)),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("copy/fill", ("memcpy", "memset", "copy", "fill")),
)


def main():
    if not torch.cuda.is_available():
        print("profile_torch_resnet: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    model = resnet50(data_format="NHWC", device="cuda",
                     generator=torch.Generator().manual_seed(0))
    opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                             parameters=model.parameters())
    step = TrainStep(model, F.cross_entropy, opt, amp_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.normal(size=(B, 3, HW, HW)).astype(
        np.float32)).permute(0, 2, 3, 1).contiguous().cuda()
    labels = torch.from_numpy(rng.integers(0, 1000, (B,))).cuda()
    for _ in range(WARMUP):
        step(imgs, labels)
    torch.cuda.synchronize()

    act = torch.profiler.ProfilerActivity
    kernels.reset_stats()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(WINDOW):
            loss = step(imgs, labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = _device_summary(prof, wall, WINDOW, GROUPS)
    out["launches_per_step"] = {k: v["kernel"] / WINDOW
                                for k, v in kernels.all_stats().items()}
    out["plain_runs"] = {k: v["plain"] for k, v in
                         kernels.all_stats().items()}

    t0 = time.perf_counter()
    for _ in range(WINDOW):
        loss = step(imgs, labels)
    torch.cuda.synchronize()
    out["wall_ms_unprofiled"] = (time.perf_counter() - t0) * 1e3 / WINDOW
    out["loss"] = float(loss)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out.update(card=smi, batch=B, hw=HW, window=WINDOW)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/profile_torch_resnet.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
