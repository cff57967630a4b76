#!/usr/bin/env python3
"""Phase 21's fp32 card-against-CPU check of Transformer-base
(``chip_smoke.transformer_cross_check``) at several seeds, and under
controls that break a kernel on purpose, which the check must fail.

    python3 tools/tb_grad_check.py                  # seeds 1-6, controls
    python3 tools/tb_grad_check.py --seeds 1,4 --no-controls

Each seed draws its own weights and batch (B 2, sources 128, targets
112, bool masks) and reports the check's readings: the loss difference,
the worst gradient error over its tolerance (2e-3 of each leaf's scale),
the parameters after one step, and how many FFN pre-activations the two
devices rounded to opposite sides of ReLU's 0 (the CPU takes the card's
branch there, ``chip_smoke.match_relu``).

The controls run the check at seed 1 with one wrapper of
``paddle_tpu_torch.ops.kernels.flash_attention`` replaced for CUDA
tensors (the CPU's plain versions stay as they are):

- ``bwd_no_mask``: the one-pass backward launched without the mask, as a
  kernel that drops its mask operand would compute;
- ``fwd_tf32``: q, k and v rounded to TF32 (10-bit significand, to
  nearest) before the fp32 forward, so that its Q K^T is what one TF32
  pass would give in place of the 3xTF32 split;
- ``bwd_tf32``: q, k, v and dO rounded so before the fp32 one-pass
  backward, so that its S, dP and the TF32 operand of each of dV, dK and
  dQ are what one TF32 pass would give.

Writes ``chiprun_out/tb_grad_check.json`` under the directory it is
started from; exits 1 when a seed fails the check or ``bwd_no_mask`` or
``bwd_tf32`` passes it. Needs one card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def tf32(x):
    """x (fp32) rounded to TF32's 10-bit significand, to nearest (ties
    away from zero, as cvt.rna.tf32.f32)."""
    import torch
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def control(name):
    """Replace one wrapper of the flash kernels for CUDA tensors while
    the block runs (see the module's docstring)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    attr = {"bwd_no_mask": "flash_attention_bwd_fused",
            "fwd_tf32": "flash_attention_fwd",
            "bwd_tf32": "flash_attention_bwd_fused"}[name]
    orig = getattr(fa, attr)

    def bwd_no_mask(q, k, v, lse, delta, do, causal=False, scale=None,
                    mask=None):
        return orig(q, k, v, lse, delta, do, causal, scale,
                    None if q.is_cuda else mask)

    def fwd_tf32(q, k, v, causal=False, scale=None, mask=None):
        if q.is_cuda:
            q, k, v = tf32(q), tf32(k), tf32(v)
        return orig(q, k, v, causal, scale, mask)

    def bwd_tf32(q, k, v, lse, delta, do, causal=False, scale=None,
                 mask=None):
        if q.is_cuda:
            q, k, v, do = tf32(q), tf32(k), tf32(v), tf32(do)
        return orig(q, k, v, lse, delta, do, causal, scale, mask)

    setattr(fa, attr, {"bwd_no_mask": bwd_no_mask, "fwd_tf32": fwd_tf32,
                       "bwd_tf32": bwd_tf32}[name])
    try:
        yield
    finally:
        setattr(fa, attr, orig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="1,2,3,4,5,6")
    ap.add_argument("--no-controls", action="store_true")
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch import _native
    if not torch.cuda.is_available():
        print("tb_grad_check: no CUDA card is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _native.load()
    res = {"seeds": [cs.transformer_cross_check(int(s), hold=False)
                     for s in args.seeds.split(",")], "controls": {}}
    if not args.no_controls:
        for name in ("bwd_no_mask", "fwd_tf32", "bwd_tf32"):
            with control(name):
                res["controls"][name] = cs.transformer_cross_check(
                    1, hold=False)
    keys = ("held", "relu_flips", "loss_err", "grad_err_over_tol",
            "param_err")
    for r in res["seeds"]:
        print(f"seed {r['seed']}: " + json.dumps({k: r[k] for k in keys}))
    for name, r in res["controls"].items():
        print(f"control {name}: " + json.dumps({k: r[k] for k in keys}))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "tb_grad_check.json"), "w") as f:
        json.dump(res, f, indent=1)
    ok = all(r["held"] for r in res["seeds"]) and not any(
        res["controls"].get(name, {"held": False})["held"]
        for name in ("bwd_no_mask", "bwd_tf32"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
