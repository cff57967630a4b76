#!/usr/bin/env python3
"""Where the fp32 flash backward should split Q and dO into TF32 hi and lo.

    python3 tools/ab_bwd_split.py      # from the repository root

The 3xTF32 k-tile walk of the fp32 backward
(``paddle_tpu_torch/csrc/flash_attention_bwd.cuh``, ``kv_walk_tf32``),
the one-pass kernel and the split pair's dk/dv kernel, reads Q and dO in
two products each. This tool builds ``flash_attention_bwd.cu`` and
``flash_attention_bwd_split.cu`` three times into libraries of their own,
with ``PT_TF32_BWD_PRESPLIT`` set by ``-D`` or not:

* ``at_load``: 0, each fragment split in registers where it is loaded;
* ``presplit``: 1, Q and dO split once a q tile into hi and lo planes in
  shared memory;
* ``ship``: the sources' own choice (``tf32_presplit``: the planes where
  two blocks still fit an SM).

It times each library's one-pass backward (with its zeroed fp32 dq) in
fp32 at the ``Model.fit`` step's B 8 L 1,024 H 12 D 64 causal, BERT's
B 256 L 128 non-causal and B 2 L 1,024 H 16 D 128 causal, and its split
dk/dv kernel at B 1 L 4,096 H 12 D 64 causal, from replayed CUDA graphs
(``chip_smoke.cuda_ms``), and holds every output against the package's
plain versions within ``chip_smoke.bwd_tol``. Writes ``ab_bwd_split.json``
(and the builds) under ``chip_smoke.OUT_DIR``. Needs one card and
``nvcc``.
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
#: name: -DPT_TF32_BWD_PRESPLIT value (None: the sources' own choice)
VARIANTS = {"at_load": 0, "presplit": 1, "ship": None}


def build(name: str, presplit):
    """The two backward sources with this switch (None: without it), as a
    library of its own."""
    d = os.path.join(OUT, "ab_bwd_split", name)
    os.makedirs(d, exist_ok=True)
    lib = os.path.join(d, "lib.so")
    flags = ([] if presplit is None
             else [f"-DPT_TF32_BWD_PRESPLIT={presplit}"])
    return lib, subprocess.Popen(
        [_native.nvcc_path(), "-gencode", _native.GENCODE, "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-shared", f"-I{CSRC}", *flags,
         "-Xptxas=-v", "-o", lib,
         os.path.join(CSRC, "flash_attention_bwd.cu"),
         os.path.join(CSRC, "flash_attention_bwd_split.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def spills(log: str) -> list:
    """(kernel, registers, spill bytes) of the 3xTF32 kernels in a
    -Xptxas=-v log."""
    rows, lines = [], log.splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and "tf32" in line:
            name = line.split("for ")[-1]
            regs = lines[i + 2].split("Used ")[-1].split(" ")[0]
            spill = lines[i + 1].split(", ")[1].split(" ")[0]
            rows.append((name[-60:], int(regs), int(spill)))
    return rows


def main():
    if not torch.cuda.is_available():
        print("ab_bwd_split: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    builds = {name: build(name, v) for name, v in VARIANTS.items()}
    libs, regs = {}, {}
    sig = ([ctypes.c_void_p] * 10 + [ctypes.c_int64] * 16
           + [ctypes.c_int] * 6
           + [ctypes.c_float, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
              ctypes.c_void_p])
    for name, (path, proc) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs[name] = spills(log)
        lib = ctypes.CDLL(path)
        lib.pt_flash_attention_bwd.restype = ctypes.c_int
        lib.pt_flash_attention_bwd.argtypes = sig
        lib.pt_flash_attention_bwd_dkv.restype = ctypes.c_int
        lib.pt_flash_attention_bwd_dkv.argtypes = sig[:1] * 9 + sig[10:]
        libs[name] = lib
    _native.load()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    f32 = torch.float32
    res = {}
    for B, L, H, D, causal, what in (
            (8, 1024, 12, 64, True, "one-pass"),
            (256, 128, 12, 64, False, "one-pass"),
            (2, 1024, 16, 128, True, "one-pass"),
            (1, 4096, 12, 64, True, "dk/dv")):
        q, k, v, do = cs._attention_inputs(dev, gen, B, L, L, H, D, f32)
        out, lse = fa.flash_attention_fwd(q, k, v, causal)
        delta = fa.attention_delta(out, do)
        ref = fa.flash_attention_bwd_plain(q, k, v, lse, delta, do, causal)
        do, lse, delta, tail = fa._bwd_launch_args(
            q, k, v, lse, delta, do, causal, D ** -0.5, None)
        row = {}
        for name, lib in libs.items():
            def call(lib=lib):
                dk, dv = torch.empty_like(k), torch.empty_like(v)
                design = ctypes.c_int(-1)
                stream = torch.cuda.current_stream().cuda_stream
                if what == "one-pass":
                    dq = torch.zeros_like(q)
                    _native.check(lib.pt_flash_attention_bwd(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *tail,
                        ctypes.byref(design), stream), name)
                    got = (dq, dk, dv)
                else:
                    _native.check(lib.pt_flash_attention_bwd_dkv(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dk.data_ptr(), dv.data_ptr(), *tail,
                        ctypes.byref(design), stream), name)
                    got = (None, dk, dv)
                if fa.DESIGNS[design.value] != "mma.sync-3xtf32":
                    raise AssertionError(f"{name}: design {design.value}")
                return got
            got = call()
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                if g is not None and cs.max_err(g, r) > cs.bwd_tol(f32, r):
                    raise AssertionError(f"{name} {what} B{B} L{L} D{D}: "
                                         f"error {cs.max_err(g, r)}")
            row[name] = cs.cuda_ms(call, iters=5, reps=3)
        key = (f"{what} fp32 B{B} L{L} H{H} D{D} "
               f"{'causal' if causal else 'non-causal'}")
        res[key] = row
        print(key, json.dumps(row), flush=True)
        del q, k, v, do, out, lse, delta, ref
        torch.cuda.empty_cache()
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "ab_bwd_split.json"), "w") as f:
        json.dump(dict(card=smi, ms=res, registers_spill_bytes=regs), f,
                  indent=1)
    for name, rows in regs.items():
        print(name, json.dumps(rows))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
