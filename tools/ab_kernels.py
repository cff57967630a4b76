#!/usr/bin/env python3
"""Time the attention and 1x1-conv kernels of one checkout, for comparing
two checkouts on one card.

    python3 tools/ab_kernels.py --tree DIR --tag NAME   # one checkout
    python3 tools/ab_kernels.py --compare NAME NAME ... # after the runs

Each run imports the kernels of the checkout at DIR (its
``paddle_tpu_torch`` and its ``chip_smoke`` helpers, so an older checkout
works too), builds them there, and times, from replayed CUDA graphs
(``chip_smoke.cuda_ms``): the flash forward in fp32 at the serving
buckets (B 1, L 512 and 1,024), the forward and the one-pass backward at
B 8 L 1,024 (the one-pass backward also at B 8 L 512 and at B 2 L 1,024
H 16 D 128), the paged decode attention at the serving path's 32 lanes
(fp32 and bf16) and the forward, the split dq and dk/dv kernels at B 1
L 4,096 and 32,768 (the one-pass kernel there too), in fp32 and bf16, all
H 12 D 64 causal; and the bf16 1x1 conv + statistics at ResNet-50's
layer2 and layer4 shapes and one small one, whose outputs (y, sum, sumsq)
it hashes. It writes ``chiprun_out/ab_NAME.json`` under the directory it
is started from. ``--compare`` prints,
for each timing, the runs side by side, and whether every run's conv
outputs hash alike (bit for bit). Run the checkouts in turns in one call
(parent, change, change, parent): two calls may land on two cards. Needs
one card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

#: where the runs' files go: chiprun_out/ under the directory the tool
#: is started from (the tool moves into the checkout it times)
OUT = os.path.abspath("chiprun_out")


def run(tree: str, tag: str) -> dict:
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch import _native
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_conv_bn as fcb
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: no CUDA card is available")
    _native.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    ms = {}
    for L in (512, 1024):
        q, k, v, _ = cs._attention_inputs(dev, gen, 1, L, L, 12, 64, f32)
        ms[f"forward float32 B1 L{L}"] = cs.cuda_ms(
            lambda: fa.flash_attention_fwd(q, k, v, True))
    for dt in (f32, bf16):
        name = str(dt)[6:]
        q, k, v, do = cs._attention_inputs(dev, gen, 8, 1024, 1024, 12, 64,
                                           dt)
        out, lse = fa.flash_attention_fwd(q, k, v, True)
        ms[f"forward {name} B8 L1024"] = cs.cuda_ms(
            lambda: fa.flash_attention_fwd(q, k, v, True))
        ms[f"one-pass backward {name} B8 L1024"] = cs.cuda_ms(
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, True),
            iters=5, reps=3)
        for B, L, H, D in ((8, 512, 12, 64), (2, 1024, 16, 128)):
            q, k, v, do = cs._attention_inputs(dev, gen, B, L, L, H, D, dt)
            out, lse = fa.flash_attention_fwd(q, k, v, True)
            ms[f"one-pass backward {name} B{B} L{L} H{H} D{D}"] = cs.cuda_ms(
                lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, True),
                iters=5, reps=3)
        for L in (4096, 32768):
            q, k, v, do = cs._attention_inputs(dev, gen, 1, L, L, 12, 64, dt)
            out, lse = fa.flash_attention_fwd(q, k, v, True)
            delta = fa.attention_delta(out, do)
            n = (1, 3) if L > 8192 else (5, 3)
            calls = {
                "forward": lambda: fa.flash_attention_fwd(q, k, v, True),
                "split dq": lambda: fa.flash_attention_bwd_dq(
                    q, k, v, lse, delta, do, True),
                "split dk/dv": lambda: fa.flash_attention_bwd_dkv(
                    q, k, v, lse, delta, do, True)}
            if L > 8192:
                calls["one-pass backward"] = (
                    lambda: fa.flash_attention_bwd_fused(
                        q, k, v, lse, delta, do, True))
            for what, fn in calls.items():
                ms[f"{what} {name} B1 L{L}"] = cs.cuda_ms(
                    fn, iters=n[0], reps=n[1], warmup=1)
            del q, k, v, do, out, lse, delta
            torch.cuda.empty_cache()
    # paged decode attention at the serving path's shape: 32 lanes, GPT-2
    # small's heads, page 16, contexts 32..1024
    W, H, D, page, max_len = 32, 12, 64, 16, 1024
    pps = max_len // page
    rng = np.random.default_rng(0)
    ctx = rng.integers(32, max_len + 1, W).astype(np.int32)
    ctx[:2] = (32, max_len)
    bt = torch.from_numpy((1 + rng.permutation(W * pps)).astype(np.int32)
                          .reshape(W, pps)).to(dev)
    cl = torch.from_numpy(ctx).to(dev)
    for dt in (f32, bf16):
        q = torch.randn(W, H, D, device=dev, generator=gen).to(dt)
        kp, vp = (torch.randn(1 + W * pps, page, H, D, device=dev,
                              generator=gen).to(dt) for _ in range(2))
        ms[f"paged attention {str(dt)[6:]} W32 ctx 32-1024"] = cs.cuda_ms(
            lambda: pa.paged_attention(q, kp, vp, bt, cl))
    gen = torch.Generator(device=dev).manual_seed(1)
    digests = {}
    for R, Cin, Cout in ((100352, 512, 128), (6272, 512, 2048),
                         (1000, 64, 24)):
        x = torch.randn(R, Cin, device=dev, generator=gen).to(bf16)
        w = (torch.randn(Cout, Cin, device=dev, generator=gen)
             / Cin ** 0.5).to(bf16)
        h = hashlib.sha256()
        for t in fcb.conv1x1_stats(x, w):
            h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
        shape = f"R{R} {Cin}->{Cout}"
        digests[shape] = h.hexdigest()
        ms[f"conv1x1 bfloat16 {shape}"] = cs.cuda_ms(
            lambda: fcb.conv1x1_stats(x, w), iters=5, reps=3)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    res = dict(tag=tag, tree=tree, card=smi, ms=ms, conv1x1_sha256=digests)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, f"ab_{tag}.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return res


def compare(tags) -> None:
    runs = [json.load(open(os.path.join(OUT, f"ab_{t}.json"))) for t in tags]
    print(f"{'ms':<40}" + "".join(f"{t:>12}" for t in tags)
          + f"   [{runs[0]['card']}]")
    for key in runs[0]["ms"]:
        print(f"{key:<40}" + "".join(f"{r['ms'][key]:>12.4f}" for r in runs))
    for shape, digest in runs[0]["conv1x1_sha256"].items():
        same = all(r["conv1x1_sha256"][shape] == digest for r in runs)
        print(f"conv1x1 bf16 {shape}: outputs bit for bit across runs: "
              f"{same}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=".", help="the checkout to time")
    ap.add_argument("--tag", help="name of this run's output file")
    ap.add_argument("--compare", nargs="+", metavar="TAG",
                    help="print the runs of these tags side by side")
    args = ap.parse_args()
    if args.compare:
        compare(args.compare)
    elif args.tag:
        run(args.tree, args.tag)
    else:
        ap.error("give --tag (with --tree) or --compare")


if __name__ == "__main__":
    main()
