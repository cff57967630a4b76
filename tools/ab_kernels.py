#!/usr/bin/env python3
"""Time the layer-norm, attention, 1x1-conv and softmax CE kernels of one
checkout, for comparing two checkouts on one card.

    python3 tools/ab_kernels.py --tree DIR --tag NAME   # one checkout
    python3 tools/ab_kernels.py --tree DIR --tag NAME --only layer_norm
    python3 tools/ab_kernels.py --compare NAME NAME ... # after the runs

Each run imports the kernels of the checkout at DIR (its
``paddle_tpu_torch`` and its ``chip_smoke`` helpers, so an older checkout
works too), builds them there, and times, from replayed CUDA graphs
(``chip_smoke.cuda_ms``): the layer norm's forward (``layer_norm_fwd``)
at R 32 and 1,024 N 768 fp32, R 8,192 N 768 fp32 and bf16, R 32,768 N
768 bf16 and R 4,096 N 512 bf16, and its backward (``layer_norm_bwd``,
which is a torch composition in a checkout older than its kernel) at the
training paths' shapes; the flash forward in fp32 at the serving
buckets (B 1, L 16 to 1,024), the forward and the one-pass backward at
B 8 L 1,024 (the one-pass backward also at B 8 L 512 and at B 2 L 1,024
H 16 D 128), the paged decode attention at the serving path's 32 lanes
(fp32 and bf16) and the forward, the split dq and dk/dv kernels at B 1
L 4,096 and 32,768 (the one-pass kernel there too), in fp32 and bf16, all
H 12 D 64 causal; and the 1x1 conv + statistics, bf16 and fp32, at the
12 shapes of the ResNet-50 step (``CONV_SHAPES``) and one small one, whose outputs (y,
sum, sumsq) it hashes; and the softmax CE's forward, backward and
forward again at the paths' shapes (``CE_ROWS``, PERF.md rows 8-9). It
writes
``chiprun_out/ab_NAME.json`` under the directory it is started from.
``--only`` names the groups to time (layer_norm, attention, paged,
conv1x1, softmax_ce; all by default). ``--compare`` prints,
for each timing, the runs side by side, and each run's conv output hash
(runs of one checkout must agree bit for bit). Run the checkouts in turns in one call
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
#: the ResNet-50 step's 1x1 conv shapes (R, Cin, Cout), as
#: chip_smoke.RESNET_CONV_SHAPES lists them
CONV_SHAPES = ((401408, 64, 64), (401408, 256, 64), (401408, 64, 256),
               (401408, 256, 128), (100352, 512, 128), (100352, 128, 512),
               (100352, 512, 256), (25088, 1024, 256), (25088, 256, 1024),
               (25088, 1024, 512), (6272, 2048, 512), (6272, 512, 2048))


#: the layer norm's forward (R, N, type) and backward rows (R, N, type, eps)
LN_FWD = ((32, 768, "float32"), (1024, 768, "float32"),
          (8192, 768, "float32"), (8192, 768, "bfloat16"),
          (32768, 768, "bfloat16"), (4096, 512, "bfloat16"))
LN_BWD = ((8192, 768, "bfloat16", 1e-5), (8192, 768, "float32", 1e-5),
          (32768, 768, "bfloat16", 1e-12), (4096, 512, "bfloat16", 1e-5))
#: the softmax CE rows (N, V, type) of PERF.md rows 8-9: GPT b8 (O2 and
#: Model.fit), ResNet's head, the long path, BERT's and ERNIE's heads,
#: Transformer-base's
CE_ROWS = ((8192, 50304, "bfloat16"), (8192, 50304, "float32"),
           (128, 1000, "float32"), (128, 1000, "bfloat16"),
           (32768, 50304, "bfloat16"), (256, 2, "bfloat16"),
           (4096, 40000, "bfloat16"), (3584, 37000, "bfloat16"))
GROUPS = ("layer_norm", "attention", "paged", "conv1x1", "softmax_ce")


def run(tree: str, tag: str, only=GROUPS) -> dict:
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch import _native
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_conv_bn as fcb
    from paddle_tpu_torch.ops.kernels import layer_norm as ln
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels import softmax_ce as sce
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: no CUDA card is available")
    _native.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    ms = {}
    if "layer_norm" in only:
        for R, N, dt in LN_FWD:
            dt = getattr(torch, dt)
            x = torch.randn(R, N, device=dev, generator=gen).to(dt)
            g, b = (torch.randn(N, device=dev, generator=gen).to(dt)
                    for _ in range(2))
            ms[f"layer norm {str(dt)[6:]} R{R} N{N}"] = cs.cuda_ms(
                lambda: ln.layer_norm_fwd(x, g, b))
        for R, N, dt, eps in LN_BWD:
            dt = getattr(torch, dt)
            x, dy = (torch.randn(R, N, device=dev, generator=gen).to(dt)
                     for _ in range(2))
            g = torch.randn(N, device=dev, generator=gen).to(dt)
            ms[f"layer norm backward {str(dt)[6:]} R{R} N{N} eps {eps:g}"] = (
                cs.cuda_ms(lambda: ln.layer_norm_bwd(x, g, dy, eps)))
        del x, dy, g, b
    for L in (16, 32, 64, 128, 256, 512, 1024) if "attention" in only else ():
        q, k, v, _ = cs._attention_inputs(dev, gen, 1, L, L, 12, 64, f32)
        ms[f"forward float32 B1 L{L}"] = cs.cuda_ms(
            lambda: fa.flash_attention_fwd(q, k, v, True))
    for dt in (f32, bf16) if "attention" in only else ():
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
    for dt in (f32, bf16) if "paged" in only else ():
        q = torch.randn(W, H, D, device=dev, generator=gen).to(dt)
        kp, vp = (torch.randn(1 + W * pps, page, H, D, device=dev,
                              generator=gen).to(dt) for _ in range(2))
        ms[f"paged attention {str(dt)[6:]} W32 ctx 32-1024"] = cs.cuda_ms(
            lambda: pa.paged_attention(q, kp, vp, bt, cl))
    digests = {}
    for dt in (bf16, f32) if "conv1x1" in only else ():
        gen = torch.Generator(device=dev).manual_seed(1)
        for R, Cin, Cout in (*CONV_SHAPES, (1000, 64, 24)):
            x = torch.randn(R, Cin, device=dev, generator=gen).to(dt)
            w = (torch.randn(Cout, Cin, device=dev, generator=gen)
                 / Cin ** 0.5).to(dt)
            h = hashlib.sha256()
            for t in fcb.conv1x1_stats(x, w):
                h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                         .tobytes())
            shape = f"{str(dt)[6:]} R{R} {Cin}->{Cout}"
            digests[shape] = h.hexdigest()
            ms[f"conv1x1 {shape}"] = cs.cuda_ms(
                lambda: fcb.conv1x1_stats(x, w), iters=5, reps=3)
    for N, V, dt in CE_ROWS if "softmax_ce" in only else ():
        dt = getattr(torch, dt)
        x, lab, dnll, _ = cs._ce_inputs(dev, gen, N, V, dt)
        _, lse = sce.softmax_ce_fwd(x, lab)
        n = (2, 3) if N * V > 1e9 else (10, 3) if N * V > 1e7 else (20, 5)
        name = f"{str(dt)[6:]} N{N} V{V}"
        ms[f"softmax_ce forward {name}"] = cs.cuda_ms(
            lambda: sce.softmax_ce_fwd(x, lab), iters=n[0], reps=n[1])
        ms[f"softmax_ce backward {name}"] = cs.cuda_ms(
            lambda: sce.softmax_ce_bwd(x, lab, lse, dnll), iters=n[0],
            reps=n[1])
        # the forward again, once the logits have been read some 20 times:
        # the first timing of a freshly made N 32,768 tensor can read
        # some 20 % slower than later ones
        ms[f"softmax_ce forward {name} again"] = cs.cuda_ms(
            lambda: sce.softmax_ce_fwd(x, lab), iters=n[0], reps=n[1])
        del x, lse
        torch.cuda.empty_cache()
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
    keys = list(dict.fromkeys(k for r in runs for k in r["ms"]))
    for key in keys:
        print(f"{key:<40}" + "".join(
            f"{r['ms'][key]:>12.4f}" if key in r["ms"] else f"{'-':>12}"
            for r in runs))
    shapes = dict.fromkeys(s for r in runs
                           for s in r.get("conv1x1_sha256", {}))
    for shape in shapes:
        print(f"conv1x1 {shape:<30} sha256 " + " ".join(
            r.get("conv1x1_sha256", {}).get(shape, "-")[:12] for r in runs))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=".", help="the checkout to time")
    ap.add_argument("--tag", help="name of this run's output file")
    ap.add_argument("--compare", nargs="+", metavar="TAG",
                    help="print the runs of these tags side by side")
    ap.add_argument("--only", default=",".join(GROUPS),
                    help="comma-separated groups to time: "
                    + ", ".join(GROUPS))
    args = ap.parse_args()
    only = args.only.split(",")
    if not set(only) <= set(GROUPS):
        ap.error(f"--only: names of {GROUPS}")
    if args.compare:
        compare(args.compare)
    elif args.tag:
        run(args.tree, args.tag, only)
    else:
        ap.error("give --tag (with --tree) or --compare")


if __name__ == "__main__":
    main()
