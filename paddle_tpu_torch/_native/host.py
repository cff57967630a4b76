"""Build and load the host library: the parameter server's table server and
client (counterpart of ``paddle_tpu/_native/__init__.py``'s ``ps_*``
entries).

The port keeps its own copy of the C++ sources under ``host_csrc/``
(``ps.cc`` and ``net.h``). They compile with ``g++`` into
``build/libpaddle_tpu_torch_host.so`` on first use, under a file lock
(several processes may start at once), and again whenever a source is
newer than the library, as the CUDA kernels do (``_native/__init__.py``).
``ctypes`` binds the plain C interface. A failed build raises; nothing
falls back.

Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import pathlib
import subprocess
import threading

_DIR = pathlib.Path(__file__).resolve().parent
_CSRC = _DIR / "host_csrc"
_BUILD = _DIR.parent / "build"
_LIB = _BUILD / "libpaddle_tpu_torch_host.so"

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(_CSRC.glob("*.cc"))


def _stale() -> bool:
    if not _LIB.exists():
        return True
    lib_mtime = _LIB.stat().st_mtime
    deps = (*_sources(), *_CSRC.glob("*.h"))
    return any(p.stat().st_mtime > lib_mtime for p in deps)


def build(verbose: bool = False) -> pathlib.Path:
    """Compile host_csrc/*.cc into the shared library (idempotent,
    file-locked)."""
    _BUILD.mkdir(exist_ok=True)
    with open(_BUILD / ".host_build.lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if not _stale():
                return _LIB
            tmp = _BUILD / (_LIB.name + ".tmp")
            cmd = (["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-pthread", "-o", str(tmp)]
                   + [str(s) for s in _sources()])
            if verbose:
                print("[paddle_tpu_torch._native.host]", " ".join(cmd))
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"g++ failed building the host library:\n"
                                   f"{r.stdout}{r.stderr}")
            os.replace(tmp, _LIB)
            return _LIB
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def load() -> ctypes.CDLL:
    """Load (building if needed) the host library and declare signatures."""
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
    u64p = c.POINTER(c.c_uint64)
    f32p = c.POINTER(c.c_float)
    i32p = c.POINTER(c.c_int32)
    i64p = c.POINTER(c.c_int64)
    sigs = {
        "ps_server_create": (c.c_int, [c.c_int]),
        "ps_server_port": (c.c_int, [c.c_int]),
        "ps_server_start": (c.c_int, [c.c_int]),
        "ps_server_wait": (c.c_int, [c.c_int]),
        "ps_server_stop": (c.c_int, [c.c_int]),
        "ps_connect": (c.c_int, [c.c_char_p, c.c_int, c.c_int]),
        "ps_ping": (c.c_int, [c.c_int]),
        "ps_create_table": (c.c_int, [c.c_int, c.c_int, c.c_int, c.c_int,
                                      c.c_int64, c.c_int, c.c_float,
                                      c.c_float, c.c_uint64]),
        "ps_pull_dense": (c.c_int, [c.c_int, c.c_int, f32p, c.c_int64,
                                    c.c_int64]),
        "ps_push_dense": (c.c_int, [c.c_int, c.c_int, f32p, c.c_int64,
                                    c.c_int64]),
        "ps_set_dense": (c.c_int, [c.c_int, c.c_int, f32p, c.c_int64,
                                   c.c_int64]),
        "ps_pull_sparse": (c.c_int, [c.c_int, c.c_int, u64p, c.c_int64,
                                     f32p, c.c_int64]),
        "ps_push_sparse": (c.c_int, [c.c_int, c.c_int, u64p, c.c_int64,
                                     f32p, c.c_int64]),
        "ps_table_size": (c.c_int64, [c.c_int, c.c_int]),
        "ps_save": (c.c_int, [c.c_int, c.c_char_p]),
        "ps_load": (c.c_int, [c.c_int, c.c_char_p]),
        "ps_barrier": (c.c_int, [c.c_int, c.c_char_p, c.c_int]),
        "ps_stop_server": (c.c_int, [c.c_int]),
        "ps_push_show_click": (c.c_int, [c.c_int, c.c_int, u64p, c.c_int64,
                                         f32p, f32p]),
        "ps_shrink": (c.c_int64, [c.c_int, c.c_int, c.c_float, c.c_int]),
        "ps_pull_meta": (c.c_int, [c.c_int, c.c_int, u64p, c.c_int64, f32p,
                                   f32p, i32p]),
        "ps_set_spill": (c.c_int, [c.c_int, c.c_int, c.c_char_p]),
        "ps_spill_cold": (c.c_int64, [c.c_int, c.c_int, c.c_int]),
        "ps_spilled_size": (c.c_int64, [c.c_int, c.c_int]),
        "ps_graph_add_edges": (c.c_int, [c.c_int, c.c_int, u64p, u64p, f32p,
                                         c.c_int64]),
        "ps_graph_sample": (c.c_int64, [c.c_int, c.c_int, u64p, c.c_int64,
                                        c.c_int, c.c_uint64, i32p, u64p]),
        "ps_graph_degree": (c.c_int, [c.c_int, c.c_int, u64p, c.c_int64,
                                      i64p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
