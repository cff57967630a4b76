#!/usr/bin/env python3
"""Which query tile the fp32 flash forward should take at serving's
prefill buckets.

    python3 tools/ab_fwd_q_tile.py      # from the repository root

The fp32 tensor-core forward (``paddle_tpu_torch/csrc/flash_attention.cu``,
``flash_fwd_tf32_kernel``) runs a 2-warp block of 32 query rows (32-key
tiles) at D 64 for Lq up to ``PT_TF32_Q32_MAX_LQ``, else a 4-warp block
of 64 rows (64-key tiles). This tool builds ``flash_attention.cu`` three
times into libraries of its own, with that limit set by ``-D``:

* ``q64``: 0, the 64-row block at every length;
* ``ship``: the source's own limit;
* ``q32``: 1,024, the 32-row block at every bucket.

It times each library's forward in fp32, causal, B 1 H 12 D 64, at the
buckets L 16 to 1,024 (from replayed CUDA graphs, ``chip_smoke.cuda_ms``),
and checks each output against the package's plain version within
``chip_smoke.TOL``. Writes ``ab_fwd_q_tile.json`` (and the builds) under
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
from paddle_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402

CSRC = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
OUT = os.path.join(ROOT, cs.OUT_DIR)
#: name: -DPT_TF32_Q32_MAX_LQ value (None: the source's own)
VARIANTS = {"q64": 0, "ship": None, "q32": 1024}
BUCKETS = (16, 32, 64, 128, 256, 512, 1024)


def build(name: str, limit):
    """flash_attention.cu with this limit, as a library of its own."""
    d = os.path.join(OUT, "ab_fwd_q_tile", name)
    os.makedirs(d, exist_ok=True)
    lib = os.path.join(d, "lib.so")
    flags = [] if limit is None else [f"-DPT_TF32_Q32_MAX_LQ={limit}"]
    return lib, subprocess.Popen(
        [_native.nvcc_path(), "-gencode", _native.GENCODE, "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-shared", f"-I{CSRC}", *flags, "-o",
         lib, os.path.join(CSRC, "flash_attention.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main():
    if not torch.cuda.is_available():
        print("ab_fwd_q_tile: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    builds = {name: build(name, lim) for name, lim in VARIANTS.items()}
    libs = {}
    for name, (path, proc) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(path)
        lib.pt_flash_attention_fwd.restype = ctypes.c_int
        lib.pt_flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 13
            + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
               ctypes.c_void_p])
        libs[name] = lib
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    H, D = 12, 64
    res = {}
    for L in BUCKETS:
        q, k, v, _ = cs._attention_inputs(dev, gen, 1, L, L, H, D,
                                          torch.float32)
        ref, _ = fa.flash_attention_plain(q, k, v, True, D ** -0.5)
        row = {}
        for name, lib in libs.items():
            def call(lib=lib):
                out = torch.empty_like(q)
                lse = torch.empty(1, H, L, dtype=torch.float32, device=dev)
                design = ctypes.c_int(-1)
                _native.check(lib.pt_flash_attention_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), None, *q.stride()[:3],
                    *k.stride()[:3], *v.stride()[:3], 0, 0, 0, 0, 1, H, L,
                    L, D, 1, D ** -0.5, 0,
                    ctypes.byref(design),
                    torch.cuda.current_stream().cuda_stream), name)
                if fa.DESIGNS[design.value] != "mma.sync-3xtf32":
                    raise AssertionError(f"{name}: design {design.value}")
                return out
            err = cs.max_err(call(), ref)
            if err > cs.TOL[torch.float32]:
                raise AssertionError(f"{name} L {L}: error {err}")
            row[name] = cs.cuda_ms(call)
        key = f"fp32 B1 L{L} H{H} D{D} causal"
        res[key] = row
        print(key, json.dumps(row), flush=True)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "ab_fwd_q_tile.json"), "w") as f:
        json.dump(dict(card=smi, ms=res), f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
