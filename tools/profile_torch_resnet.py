#!/usr/bin/env python3
"""Where the time goes in one ResNet-50 training step of the PyTorch/H100
port.

    python3 tools/profile_torch_resnet.py     # from the repository root
    python3 tools/profile_torch_resnet.py --tree DIR --tag NAME
    python3 tools/profile_torch_resnet.py --fp32 [--cudnn-tf32 off]

Builds ResNet-50 (NHWC, fused BN, fused 1x1 conv + BN, 1000 classes,
random weights from seed 0) and trains it with
``paddle_tpu_torch.jit.TrainStep(model, F.cross_entropy, Momentum(0.1,
0.9), amp_dtype=torch.bfloat16)`` at batch 128, 224x224 on one card (the
JAX package's ``bench_resnet50`` configuration, NHWC without remat), or
with ``--fp32`` in fp32 as ``hapi.Model`` trains it
(``Model(net).prepare(Momentum(0.1, 0.9), F.cross_entropy)``, one
``train_batch`` a step: the step ``Model.fit`` takes, as ``chip_smoke.py``'s
resnet_fit phase drives it) under PyTorch's default TF32 flags (fp32
matrix products in full fp32; cuDNN's ``allow_tf32`` True, which the
port's fp32 ``conv2d`` switches off inside its calls), or with
``--cudnn-tf32 off`` the global cuDNN flag off too (for a checkout whose
``conv2d`` does not switch it). After two warm-up steps it measures, with
``torch.profiler`` (CPU and CUDA activities), a window of steps:

* host wall time per step, device busy time (the sum of device-side event
  times on the one stream) and the idle share 1 - busy / wall;
* device time per group: the cuDNN convolutions (3x3, 7x7, strided and
  the downsample 1x1s, forward and backward), the 1x1 conv + statistics
  kernel and its column-sum pass, the fused-BN kernels (the reduce with
  its column-sum pass), the softmax-CE kernels, the matrix
  products (the 1x1 chain's dx and dw), pooling, the optimizer's
  multi-tensor update, other elementwise and reduction kernels, copies;
* the 1x1 conv + statistics group's device time a step, on its own;
* the top kernels, and each hand-written kernel's launches per step;

and the same window without the profiler, for its overhead; twice, the
step as a user calls it (``"captured"``, a CUDA graph replay on a card)
and then uncaptured (``"uncaptured"``, ``TrainStep._step_uncaptured``),
as ``profile_torch_train.py`` does. Writes
``chiprun_out/profile_torch_resnet.json`` under the directory it is
started from (``profile_torch_resnet_fp32.json`` with ``--fp32``, then
``_NAME`` with ``--tag``). With
``--tree`` it profiles the checkout at DIR (its ``paddle_tpu_torch``), so
two checkouts can be compared in turns in one call. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

B, HW = 128, 224
#: chiprun_out/ under the directory the tool is started from
OUT = os.path.abspath("chiprun_out")
#: the group of the 1x1 conv + statistics kernel and its second pass
CONV_GROUP = "conv1x1 + stats (kernel)"
WARMUP, WINDOW = 2, 3

#: device-kernel name fragments -> group (first match wins)
GROUPS = (
    # each kernel's second pass, column_sums_kernel<tag>, goes with it
    (CONV_GROUP, ("conv1x1_bf16_kernel", "conv1x1_wgmma_kernel",
                   "conv1x1_f32_kernel", "conv1x1_tf32_kernel",
                   "split_w_tf32_kernel", "conv1x1_sums")),
    ("fused BN forward (kernel)", ("bn_fwd_kernel",)),
    ("fused BN reduce (kernel)", ("bn_reduce_kernel", "bn_reduce_sums")),
    ("fused BN dx (kernel)", ("bn_dx_kernel",)),
    ("softmax CE (kernels)", ("ce_fwd_", "ce_bwd_")),
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
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the checkout to profile")
    ap.add_argument("--tag", help="suffix of the output file's name")
    ap.add_argument("--fp32", action="store_true",
                    help="the fp32 step of hapi.Model (Model.fit's)")
    ap.add_argument("--cudnn-tf32", choices=("default", "off"),
                    default="default",
                    help="cuDNN's global allow_tf32: PyTorch's default "
                    "(True) or off")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_resnet: no CUDA card", file=sys.stderr)
        return 2
    os.chdir(os.path.abspath(args.tree))
    sys.path.insert(0, os.getcwd())
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.resnet import resnet50
    from paddle_tpu_torch.nn import functional as F
    # after the checkout's package: this helper's module imports it too
    from profile_torch_train import graph_counters, profile_modes, \
        step_modes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = args.cudnn_tf32 == "default"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    model = resnet50(data_format="NHWC", device="cuda",
                     generator=torch.Generator().manual_seed(0))
    opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                             parameters=model.parameters())
    if args.fp32:
        from paddle_tpu_torch.hapi import Model
        m = Model(model)
        m.prepare(opt, F.cross_entropy)

        def step(imgs, labels):
            return m.train_batch([imgs], [labels])[0]
    else:
        step = TrainStep(model, F.cross_entropy, opt,
                         amp_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.normal(size=(B, 3, HW, HW)).astype(
        np.float32)).permute(0, 2, 3, 1).contiguous().cuda()
    labels = torch.from_numpy(rng.integers(0, 1000, (B,))).cuda()
    if args.fp32:
        m.train_batch([imgs], [labels])  # builds the step
    ts = m._train_step if args.fp32 else step
    out = profile_modes(step_modes(step, ts, args.fp32), (imgs, labels),
                        WARMUP, WINDOW, GROUPS)
    for o in out.values():
        del o["_prof"]
        o["conv1x1_ms_per_step"] = o["groups"].get(CONV_GROUP, {}).get(
            "device_ms", 0.0)
    out["graphs"] = graph_counters(ts)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out.update(card=smi, tree=os.getcwd(), batch=B, hw=HW, window=WINDOW,
               dtype="float32" if args.fp32 else "O2 bfloat16",
               cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    os.makedirs(OUT, exist_ok=True)
    name = ("profile_torch_resnet" + ("_fp32" if args.fp32 else "")
            + (f"_{args.tag}" if args.tag else ""))
    with open(os.path.join(OUT, name + ".json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
