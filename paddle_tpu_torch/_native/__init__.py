"""Build and load the hand-written CUDA kernels.

Counterpart of ``paddle_tpu/_native/__init__.py``: the sources under
``paddle_tpu_torch/csrc/`` compile into one shared library the first
time a kernel is launched, under a file lock (several processes may
start at once), and again whenever a source is newer than the library.
Each ``.cu`` file compiles in its own ``nvcc`` process, all started
together, and the objects link into ``build/libpaddle_tpu_torch_kernels.so``.
The library has a plain C interface bound with ``ctypes``: pointers and
the stream are ``c_void_p``, and every entry returns ``cudaGetLastError()``
so :func:`check` can raise on a refused launch.

Nothing here runs at import time: this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import pathlib
import shutil
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "build"
_LIB = _BUILD / "libpaddle_tpu_torch_kernels.so"

#: target: Hopper with its architecture-specific features (wgmma, setmaxnreg)
GENCODE = "arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_lib = None
#: seconds the last build took (0.0 when the library was up to date)
last_build_seconds = 0.0


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def _stale() -> bool:
    if not _LIB.exists():
        return True
    lib_mtime = _LIB.stat().st_mtime
    deps = (*_sources(), *_CSRC.glob("*.cuh"))
    return any(p.stat().st_mtime > lib_mtime for p in deps)


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the paddle_tpu_torch kernels")
    return found


def build(verbose: bool = False) -> pathlib.Path:
    """Compile csrc/*.cu into the shared library (idempotent, file-locked)."""
    global last_build_seconds
    _BUILD.mkdir(exist_ok=True)
    with open(_BUILD / ".build.lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if not _stale():
                last_build_seconds = 0.0
                return _LIB
            t0 = time.perf_counter()
            nvcc = nvcc_path()
            common = [nvcc, "-gencode", GENCODE, "-std=c++17", "-O3",
                      "-Xcompiler", "-fPIC", f"-I{_CSRC}"]
            if verbose:
                common.append("-Xptxas=-v")
            procs = []
            for src in _sources():
                obj = _BUILD / (src.stem + ".o")
                cmd = common + ["-c", str(src), "-o", str(obj)]
                procs.append((src, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            failed = []
            for src, _, p in procs:
                out, _ = p.communicate()
                if verbose and out:
                    print(f"[paddle_tpu_torch._native] {src.name}:\n{out}")
                if p.returncode != 0:
                    failed.append(f"{src.name}:\n{out}")
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
            tmp = _BUILD / (_LIB.name + ".tmp")
            subprocess.run([nvcc, "-gencode", GENCODE, "-shared", "-o",
                            str(tmp)] + [str(o) for _, o, _ in procs],
                           check=True)
            os.replace(tmp, _LIB)
            last_build_seconds = time.perf_counter() - t0
            return _LIB
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def load() -> ctypes.CDLL:
    """Load (building if needed) the kernel library and declare signatures."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(_LIB))
            _declare(lib)
            _lib = lib
        return _lib


def _declare(lib: ctypes.CDLL):
    c = ctypes
    p, i64, i32, f32 = c.c_void_p, c.c_int64, c.c_int, c.c_float
    lib.pt_layer_norm_fwd.restype = i32
    lib.pt_layer_norm_fwd.argtypes = [p, p, p, p, i64, i32, f32, i32, i32, p]
    lib.pt_layer_norm_bwd.restype = i32
    lib.pt_layer_norm_bwd.argtypes = (
        [p] * 6 + [i64, i32, i64, f32, i32, i32, p])
    lib.pt_flash_attention_fwd.restype = i32
    # the flash entries: tensors, the mask (or null), their strides, the
    # mask's four, then sizes
    lib.pt_flash_attention_fwd.argtypes = (
        [p] * 6 + [i64] * 13 + [i32] * 6 + [f32, i32, c.POINTER(i32), p])
    lib.pt_flash_attention_bwd.restype = i32
    lib.pt_flash_attention_bwd.argtypes = (
        [p] * 10 + [i64] * 16 + [i32] * 6 + [f32, i32, c.POINTER(i32), p])
    lib.pt_flash_attention_bwd_dq.restype = i32
    lib.pt_flash_attention_bwd_dq.argtypes = (
        [p] * 8 + [i64] * 16 + [i32] * 6 + [f32, i32, c.POINTER(i32), p])
    lib.pt_flash_attention_bwd_dkv.restype = i32
    lib.pt_flash_attention_bwd_dkv.argtypes = (
        [p] * 9 + [i64] * 16 + [i32] * 6 + [f32, i32, c.POINTER(i32), p])
    lib.pt_softmax_ce_fwd.restype = i32
    lib.pt_softmax_ce_fwd.argtypes = [p, p, p, p, i64, i64, i32,
                                      c.POINTER(i32), p]
    lib.pt_softmax_ce_bwd.restype = i32
    lib.pt_softmax_ce_bwd.argtypes = [p, p, p, p, p, i64, i64, i32,
                                      c.POINTER(i32), p]
    lib.pt_paged_attention.restype = i32
    lib.pt_paged_attention.argtypes = (
        [p] * 7 + [i64, i64] + [i32] * 7 + [f32, i32, p])
    lib.pt_fused_bn_fwd.restype = i32
    lib.pt_fused_bn_fwd.argtypes = [p] * 5 + [i64] + [i32] * 4 + [p]
    lib.pt_fused_bn_bwd_reduce.restype = i32
    lib.pt_fused_bn_bwd_reduce.argtypes = (
        [p] * 7 + [i64, i32, i64, i32, i32, p])
    lib.pt_fused_bn_bwd_dx.restype = i32
    lib.pt_fused_bn_bwd_dx.argtypes = [p] * 8 + [i64] + [i32] * 4 + [p]
    lib.pt_empty.restype = i32
    lib.pt_empty.argtypes = [p]
    lib.pt_conv1x1_stats.restype = i32
    lib.pt_conv1x1_stats.argtypes = [p] * 6 + [i64, i32, i32, i64, i32, p]


def check(err: int, name: str) -> None:
    """Raise when a kernel entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
