#!/usr/bin/env python3
"""Where the softmax CE's two designs cross.

    python3 tools/ab_ce_designs.py      # from the repository root

Builds ``paddle_tpu_torch/csrc/softmax_ce.cu`` three times into libraries
of its own, with ``-D``:

* ``ship``: the source as it is;
* ``stream``: ``PT_CE_{FWD,BWD}_HOLD_MAX=0``, every row on the stream
  design;
* ``held``: ``PT_CE_{FWD,BWD}_HOLD_MAX=1024``, every row of at most 1,024
  classes held in registers (``HELD_MAX``, the most the source's
  instances hold).

Times each library's forward and backward (from replayed CUDA graphs,
``chip_smoke.cuda_ms``) over a sweep of V and N at the small heads, in
turns. Every output is checked against the package's plain versions
(``chip_smoke.CE_RTOL`` and ``ce_fwd_ratio``) and every launch's reported
design against the variant's. Writes ``ab_ce_designs.json`` under
``chip_smoke.OUT_DIR``. Needs one card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch import _native  # noqa: E402
from paddle_tpu_torch.ops.kernels import softmax_ce as sce  # noqa: E402

CSRC = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
OUT = os.path.join(ROOT, cs.OUT_DIR)
#: the widest row the ``held`` build holds
HELD_MAX = 1024
#: name: -D flags
VARIANTS = {"ship": [],
            "stream": ["-DPT_CE_FWD_HOLD_MAX=0", "-DPT_CE_BWD_HOLD_MAX=0"],
            "held": [f"-DPT_CE_FWD_HOLD_MAX={HELD_MAX}",
                     f"-DPT_CE_BWD_HOLD_MAX={HELD_MAX}"]}
f32, bf16 = torch.float32, torch.bfloat16
#: the crossing: (N, type, V sweep) of the small heads
CROSSING = ((128, f32, (10, 256, 300, 512, 1000)),
            (128, bf16, (512, 1000)),
            (256, bf16, (2, 512, 1000)),
            (256, f32, (300, 1000)), (512, f32, (300, 512, 1000)),
            (512, bf16, (1000,)), (1024, f32, (1000,)),
            (4096, bf16, (256, 1024)), (8192, f32, (256, 1024)))


def want_designs(name, V):
    """(forward, backward) designs the build `name` launches at V."""
    if name == "ship":
        return sce.fwd_design(V), sce.bwd_design(V)
    return ("ce-stream",) * 2 if name == "stream" else ("ce-warp-rows",) * 2


def build(name: str, flags):
    """softmax_ce.cu with these flags, as a library of its own."""
    d = os.path.join(OUT, "ab_ce_designs", name)
    os.makedirs(d, exist_ok=True)
    lib = os.path.join(d, "lib.so")
    return lib, subprocess.Popen(
        [_native.nvcc_path(), "-gencode", _native.GENCODE, "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-shared", f"-I{CSRC}", *flags, "-o",
         lib, os.path.join(CSRC, "softmax_ce.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(path):
    lib = ctypes.CDLL(path)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.pt_softmax_ce_fwd.restype = i32
    lib.pt_softmax_ce_fwd.argtypes = [p] * 4 + [i64, i64, i32,
                                                ctypes.POINTER(i32), p]
    lib.pt_softmax_ce_bwd.restype = i32
    lib.pt_softmax_ce_bwd.argtypes = [p] * 5 + [i64, i64, i32,
                                                ctypes.POINTER(i32), p]
    return lib


def calls(lib, x, lab, lse_in, dnll, seen):
    """(forward, backward) through `lib`, each recording its design in
    ``seen`` (a dict of two sets)."""
    N, V = x.shape
    bf = int(x.dtype == bf16)

    def fwd():
        nll = torch.empty(N, dtype=f32, device=x.device)
        lse = torch.empty_like(nll)
        d = ctypes.c_int(-1)
        _native.check(lib.pt_softmax_ce_fwd(
            x.data_ptr(), lab.data_ptr(), nll.data_ptr(), lse.data_ptr(),
            N, V, bf, ctypes.byref(d),
            torch.cuda.current_stream().cuda_stream), "fwd")
        seen["fwd"].add(sce.DESIGNS[d.value])
        return nll, lse

    def bwd():
        dl = torch.empty_like(x)
        d = ctypes.c_int(-1)
        _native.check(lib.pt_softmax_ce_bwd(
            x.data_ptr(), lab.data_ptr(), lse_in.data_ptr(),
            dnll.data_ptr(), dl.data_ptr(), N, V, bf, ctypes.byref(d),
            torch.cuda.current_stream().cuda_stream), "bwd")
        seen["bwd"].add(sce.DESIGNS[d.value])
        return dl

    return fwd, bwd


def measure(libs, names, N, V, dtype, dev, gen):
    """{variant: {fwd, bwd, design}} at one shape, checked first."""
    x, lab, dnll, _ = cs._ce_inputs(dev, gen, N, V, dtype)
    rnll, rlse = sce.softmax_ce_fwd_plain(x, lab)
    # in fp32, unrounded: a bf16 kernel rounds once against it (CE_RTOL)
    rdl = sce.softmax_ce_bwd_plain(x.float(), lab, rlse, dnll)
    # (iters, reps) of the timed graphs: fewer where a call moves GBs
    n = (2, 3) if N * V > 1e9 else (10, 3) if N * V > 1e7 else (20, 5)
    row = {}
    for name in names:
        seen = {"fwd": set(), "bwd": set()}
        fwd, bwd = calls(libs[name], x, lab, rlse, dnll, seen)
        nll, lse = fwd()
        fr = cs.ce_fwd_ratio(nll, lse, rnll, rlse)
        br = cs.rel_ratio(bwd(), rdl, cs.CE_RTOL[dtype])
        if max(fr, br) > 1.0:
            raise AssertionError(f"{name} N={N} V={V} {dtype}: forward "
                                 f"/tol {fr:.3f}, backward {br:.3f}")
        want = want_designs(name, V)
        if (seen["fwd"], seen["bwd"]) != ({want[0]}, {want[1]}):
            raise AssertionError(f"{name} N={N} V={V} {dtype}: launched "
                                 f"{seen}, want {want}")
        row[name] = dict(fwd_ms=cs.cuda_ms(fwd, iters=n[0], reps=n[1]),
                         bwd_ms=cs.cuda_ms(bwd, iters=n[0], reps=n[1]),
                         design={k: sorted(v) for k, v in seen.items()},
                         fwd_tol=fr, bwd_tol=br)
    del x, rdl
    torch.cuda.empty_cache()
    return row


def main():
    if not torch.cuda.is_available():
        print("ab_ce_designs: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    builds = {name: build(name, fl) for name, fl in VARIANTS.items()}
    libs = {}
    for name, (path, proc) in builds.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = load(path)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"crossing": {}}
    for N, dtype, Vs in CROSSING:
        for V in Vs:
            key = f"N={N} V={V} {str(dtype)[6:]}"
            res["crossing"][key] = row = measure(
                libs, ("held", "stream", "ship"), N, V, dtype, dev, gen)
            print("crossing", key, json.dumps(row), flush=True)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "ab_ce_designs.json"), "w") as f:
        json.dump(dict(card=smi, **res), f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
