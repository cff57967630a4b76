#!/usr/bin/env python3
"""What the one-pass flash backward's dq atomics cost on the card.

    python3 tools/ab_dq_epilogue.py      # from the repository root

The tensor-core walk of the one-pass backward
(``paddle_tpu_torch/csrc/flash_attention_bwd.cuh``, ``kv_walk_tc<D,
true>``) adds each block's share of dq into an fp32 buffer through
``add_dq_tile``. This tool builds ``flash_attention_bwd.cu`` three times
into libraries of their own, each with one of these bodies of
``add_dq_tile`` in place of the one the source ships:

* ``float2``: two-float atomics, two a lane and tile;
* ``float4``: lanes t and t ^ 1 swap halves of their tiles so that each
  adds four floats of one row with one atomic (half the atomics);
* ``none``: no atomic at all (the dq product is still computed and kept
  alive): a floor, not a backward, so its dq is not checked.

It times each kernel launch (with its zeroed fp32 dq, from replayed
CUDA graphs, ``chip_smoke.cuda_ms``) in bf16, causal, at the GPT training
step's B 8 L 1,024 H 12 D 64, at B 8 L 512 and at B 2 L 1,024 H 16
D 128, beside the split pair's dq and dk/dv kernels on the same inputs.
dk and dv must equal the ``float2`` build's bit for bit and dq must
agree with it within ``chip_smoke.bwd_tol``. Writes
``ab_dq_epilogue.json`` (and the builds) under ``chip_smoke.OUT_DIR``.
Needs one card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch import _native  # noqa: E402
from paddle_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402

CSRC = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
OUT = os.path.join(ROOT, cs.OUT_DIR)

FLOAT2 = """  if (in_g)
    atomicAdd(reinterpret_cast<float2*>(p + 2 * t),
              make_float2(c[0] * scale, c[1] * scale));
  if (in_g8)
    atomicAdd(reinterpret_cast<float2*>(p + row8 + 2 * t),
              make_float2(c[2] * scale, c[3] * scale));
"""
FLOAT4 = """  const bool odd = t & 1;
  const float x0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
  const float x1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
  if (odd ? in_g8 : in_g)
    atomicAdd(reinterpret_cast<float4*>(odd ? p + row8 + 2 * t - 2
                                            : p + 2 * t),
              odd ? make_float4(x0 * scale, x1 * scale, c[2] * scale,
                                c[3] * scale)
                  : make_float4(c[0] * scale, c[1] * scale, x0 * scale,
                                x1 * scale));
"""
NONE = """  if (in_g && c[0] == 1234.5f) p[2 * t] = c[1] + c[2] + c[3] + scale;
"""


def variants() -> dict:
    """{name: the walk's header with that body of add_dq_tile}."""
    cuh = open(os.path.join(CSRC, "flash_attention_bwd.cuh")).read()
    head = cuh.index("__device__ __forceinline__ void add_dq_tile(")
    start = cuh.index("{\n", head) + 2
    end = cuh.index("\n}\n", start) + 1
    return {name: cuh[:start] + body + cuh[end:]
            for name, body in (("float2", FLOAT2), ("float4", FLOAT4),
                               ("none", NONE))}


def build(name: str, cuh: str):
    """flash_attention_bwd.cu with this header, as a library of its own."""
    d = os.path.join(OUT, "ab_dq_epilogue", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    with open(os.path.join(d, "flash_attention_bwd.cuh"), "w") as f:
        f.write(cuh)
    lib = os.path.join(d, "lib.so")
    return lib, subprocess.Popen(
        [_native.nvcc_path(), "-gencode", _native.GENCODE, "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-shared", f"-I{d}", "-o", lib,
         os.path.join(d, "flash_attention_bwd.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main():
    if not torch.cuda.is_available():
        print("ab_dq_epilogue: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    builds = {name: build(name, cuh) for name, cuh in variants().items()}
    libs = {}
    for name, (path, proc) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(path)
        lib.pt_flash_attention_bwd.restype = ctypes.c_int
        lib.pt_flash_attention_bwd.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 16
            + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.c_void_p])
        libs[name] = lib
    _native.load()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {}
    for B, L, H, D in ((8, 1024, 12, 64), (8, 512, 12, 64),
                       (2, 1024, 16, 128)):
        q, k, v, do = cs._attention_inputs(dev, gen, B, L, L, H, D,
                                           torch.bfloat16)
        out, lse = fa.flash_attention_fwd(q, k, v, True)
        delta = fa.attention_delta(out, do)
        do, lse, delta, tail = fa._bwd_launch_args(
            q, k, v, lse, delta, do, True, 1.0 / D ** 0.5, None)
        row, ref = {}, None
        for name, lib in libs.items():
            def call(lib=lib):
                dq = torch.zeros(q.shape, dtype=torch.float32, device=dev)
                dk, dv = torch.empty_like(k), torch.empty_like(v)
                _native.check(lib.pt_flash_attention_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *tail,
                    ctypes.byref(ctypes.c_int()),
                    torch.cuda.current_stream().cuda_stream), name)
                return dq, dk, dv
            got = call()
            torch.cuda.synchronize()
            ref = got if ref is None else ref
            if not (torch.equal(got[1], ref[1])
                    and torch.equal(got[2], ref[2])):
                raise AssertionError(f"{name}: dk or dv differ")
            if name != "none" and (cs.max_err(got[0], ref[0])
                                   > cs.bwd_tol(torch.bfloat16, ref[0])):
                raise AssertionError(f"{name}: dq differs")
            row[name] = cs.cuda_ms(call, iters=5, reps=5)
        row["split dq"] = cs.cuda_ms(lambda: fa.flash_attention_bwd_dq(
            q, k, v, lse, delta, do, True), iters=5, reps=5)
        row["split dk/dv"] = cs.cuda_ms(lambda: fa.flash_attention_bwd_dkv(
            q, k, v, lse, delta, do, True), iters=5, reps=5)
        key = f"bf16 B{B} L{L} H{H} D{D} causal"
        res[key] = row
        print(key, json.dumps(row), flush=True)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "ab_dq_epilogue.json"), "w") as f:
        json.dump(dict(card=smi, ms=res), f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
