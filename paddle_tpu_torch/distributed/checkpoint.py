"""Fault-tolerant checkpointing, single host (counterpart of
``paddle_tpu/distributed/checkpoint.py``).

Every file is the reference's: a fixed header — magic ``PTCKPT01``, the
CRC32 and length of the pickled payload — then ``{"state", "specs",
"version": 2}`` pickled by the rules of ``framework/io.py`` (numpy
arrays; a bf16 tensor as the reference's bf16 array). So a checkpoint
written by either package loads in the other, leaf for leaf, and
``load`` detects truncated, bit-flipped and torn files and raises
``CheckpointCorruptError`` instead of a pickle traceback.

* ``latest_valid``/``load_latest_valid`` walk checkpoints newest first
  and take the newest that verifies (a corrupt final snapshot costs one
  save interval, not the job); ``PADDLE_TPU_RESUME_VALID_ONLY=1`` also
  walks past files whose weights hold NaN/Inf;
* ``CheckpointManager`` adds keep-last-N garbage collection, orphaned
  ``.tmp.*`` cleanup, and a SIGTERM handler that performs one final
  synchronous save before exit;
* ``save(..., async_save=True)`` snapshots to the host before it returns
  and writes in a background thread (``wait_all`` joins). The snapshot
  is a copy: the port's TrainStep updates its tensors in place, so the
  next step would otherwise write into the file being saved (JAX arrays
  are immutable, so the reference can keep references).

Loaded arrays come back as CPU torch tensors (numpy for the types torch
lacks). The multi-host pieces — ``CheckpointCoordinator`` (the two-phase
commit over a TCPStore), ``coordinator_from_env`` on more than one host,
``layout="sharded"`` and the sharded checkpoint module — wait for ROADMAP
A11 and raise naming it; ``coordinator_from_env`` returns None on one
host, as in the reference, and a ``mesh`` has nothing to re-shard onto.
"""
from __future__ import annotations

import os
import signal
import struct
import threading
import time
import warnings
import zlib
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..framework.io import _atomic_write, _dumps, _loads, to_host, to_torch
from ..profiler import metrics as _metrics_mod

_REG = _metrics_mod.default_registry()
_M_SAVES = _REG.counter("checkpoint_saves_total",
                        "checkpoint files published (atomic replace)")
_M_LOADS = _REG.counter("checkpoint_loads_total",
                        "checkpoint files loaded and verified")
_M_CORRUPT = _REG.counter(
    "checkpoint_corrupt_skipped_total",
    "corrupt/truncated checkpoint files detected and skipped")
_M_GC = _REG.counter("checkpoint_gc_removed_total",
                     "checkpoint and orphaned tmp files garbage-collected")
_M_PREEMPT = _REG.counter(
    "checkpoint_preemption_saves_total",
    "final synchronous saves performed by the SIGTERM preemption handler")
_M_SAVE_SECONDS = _REG.histogram("checkpoint_save_seconds",
                                 "wall time of checkpoint writes")
_M_SKIP_NONFINITE = _REG.counter(
    "checkpoint_resume_skipped_nonfinite_total",
    "CRC-valid checkpoints skipped at resume because their weights held "
    "NaN/Inf (valid-only resume, the fleet-rollback path)")

_pending_saves: list = []
_save_errors: list = []

# header: magic(8) | crc32(payload)(4, LE) | payload_len(8, LE)
_MAGIC = b"PTCKPT01"
_HEADER_FMT = struct.Struct("<8sIQ")

_A11 = "ROADMAP A11 (multi-host checkpointing)"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed verification (truncated/bit-flipped/torn)."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"corrupt checkpoint {path}: {reason}")
        self.path = path
        self.reason = reason


def _to_host(obj):
    """A host snapshot of a state tree: tensors copied to numpy (bf16 as a
    CPU tensor), numpy arrays copied, everything else as it is."""
    if isinstance(obj, torch.Tensor):
        return to_host(obj)
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _encode(blob: dict):
    """(header, payload) for a blob: written as two buffers, so a
    multi-GB payload is never copied into one."""
    payload = _dumps(blob)
    header = _HEADER_FMT.pack(_MAGIC, zlib.crc32(payload) & 0xFFFFFFFF,
                              len(payload))
    return header, payload


def _verified_payload(path: str, data: bytes) -> memoryview:
    """Header+length+CRC check; returns the pickled payload or raises
    CheckpointCorruptError. Files without the magic are legacy plain
    pickles and pass through for best-effort unpickling."""
    if not data.startswith(_MAGIC):
        return memoryview(data)
    if len(data) < _HEADER_FMT.size:
        raise CheckpointCorruptError(path, "truncated header")
    _, crc, length = _HEADER_FMT.unpack_from(data)
    payload = memoryview(data)[_HEADER_FMT.size:]
    if len(payload) != length:
        raise CheckpointCorruptError(
            path, f"payload truncated: header says {length} bytes, "
                  f"file has {len(payload)}")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise CheckpointCorruptError(
            path, f"CRC32 mismatch (stored {crc:#010x})")
    return payload


def _decode(path: str, data: bytes) -> dict:
    """Verify header+CRC and unpickle; raises CheckpointCorruptError."""
    payload = _verified_payload(path, data)
    if not len(payload):
        raise CheckpointCorruptError(path, "empty file")
    try:
        blob = _loads(payload)
    except Exception as e:
        raise CheckpointCorruptError(
            path, f"unpickle failed: {type(e).__name__}: {e}") from e
    if not isinstance(blob, dict) or "state" not in blob:
        raise CheckpointCorruptError(path, "payload is not a checkpoint blob")
    return blob


def _write_file(path: str, host_state) -> None:
    """Encode and publish one snapshot: the one place the on-disk blob
    layout is defined."""
    header, payload = _encode({"state": host_state, "specs": {},
                               "version": 2})
    _atomic_write(path, header, payload)


def save(state: Any, path: str, async_save: bool = False):
    """Checkpoint a tree of tensors/arrays. The host snapshot is taken
    before this returns; with ``async_save`` the encode and write run in a
    background thread."""
    host_state = _to_host(state)

    def write():
        t0 = time.perf_counter()
        _write_file(path, host_state)
        if _metrics_mod.enabled():
            _M_SAVES.inc()
            _M_SAVE_SECONDS.observe(time.perf_counter() - t0)

    def write_logged():
        try:
            write()
        except BaseException as e:  # surfaced by wait_all
            _save_errors.append(e)

    if async_save:
        t = threading.Thread(target=write_logged, daemon=True)
        t.start()
        _pending_saves.append(t)
    else:
        write()


def wait_all():
    """Block until every async save has been published; re-raises the first
    background failure (a silently lost checkpoint is worse than a crash)."""
    while _pending_saves:
        _pending_saves.pop().join()
    if _save_errors:
        err = _save_errors[0]
        _save_errors.clear()
        raise err


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            f"checkpoint restore onto a mesh: re-sharding waits for {_A11}")


def load(path: str, mesh=None) -> Any:
    """Restore a checkpoint's state tree (arrays as CPU torch tensors).
    Raises CheckpointCorruptError (never a bare pickle traceback) when the
    file fails header/CRC verification."""
    _no_mesh(mesh)
    with open(path, "rb") as f:
        data = f.read()
    blob = _decode(path, data)
    if _metrics_mod.enabled():
        _M_LOADS.inc()
    return to_torch(blob["state"])


def verify(path: str) -> Tuple[bool, Optional[str]]:
    """Cheap validity probe: (True, None) when the file's header, length
    and CRC check out (legacy files are fully unpickled to verify)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        return False, f"unreadable: {e}"
    try:
        if data.startswith(_MAGIC):
            _verified_payload(path, data)
        else:
            _decode(path, data)
    except CheckpointCorruptError as e:
        return False, e.reason
    return True, None


def _step_entries(dirname: str, prefix: str) -> List[Tuple[int, str]]:
    """[(step, path)] for every ``<prefix>_<step>`` entry (file or
    directory), newest step first."""
    if not os.path.isdir(dirname):
        return []
    out = []
    for fn in os.listdir(dirname):
        if not fn.startswith(prefix + "_") or ".tmp." in fn \
                or fn.endswith(".tmp"):
            continue
        try:
            step = int(fn.rsplit("_", 1)[1])
        except ValueError:
            continue
        out.append((step, os.path.join(dirname, fn)))
    out.sort(reverse=True)
    return out


def _step_files(dirname: str, prefix: str) -> List[Tuple[int, str]]:
    """[(step, path)] for ``<prefix>_<step>`` files, newest step first
    (step directories belong to the sharded layout)."""
    return [(s, p) for s, p in _step_entries(dirname, prefix)
            if not os.path.isdir(p)]


def latest(dirname: str, prefix: str = "ckpt") -> Optional[str]:
    """Newest checkpoint file `<prefix>_<step>` in dirname, or None.
    Does NOT verify — use `latest_valid` when corruption is possible."""
    files = _step_files(dirname, prefix)
    return files[0][1] if files else None


def resume_valid_only() -> bool:
    """``PADDLE_TPU_RESUME_VALID_ONLY=1``: resume skips checkpoints whose
    weights hold NaN/Inf even when they are CRC-valid."""
    return os.environ.get("PADDLE_TPU_RESUME_VALID_ONLY", "0") \
        .strip().lower() in ("1", "true", "on", "yes")


def tree_finite(obj) -> bool:
    """True when every floating-point array leaf (numpy array or torch
    tensor, bf16 included) of a state tree is finite. An unrecognised leaf
    is accepted (nothing to judge). Rollback path only — never per step."""
    try:
        if isinstance(obj, dict):
            return all(tree_finite(v) for v in obj.values())
        if isinstance(obj, (list, tuple)):
            return all(tree_finite(v) for v in obj)
        if isinstance(obj, torch.Tensor):
            return not obj.is_floating_point() or bool(
                torch.isfinite(obj).all())
        if isinstance(obj, np.ndarray) and obj.dtype.kind == "f":
            return bool(np.all(np.isfinite(obj)))
        return True
    except Exception:
        return True  # unjudgeable: accept rather than wedge a resume


def _note_nonfinite_skip(path: str):
    warnings.warn(f"skipping numerically-invalid checkpoint {path} "
                  f"(nonfinite weights; valid-only resume)")
    if _metrics_mod.enabled():
        _M_SKIP_NONFINITE.inc()


def _note_corrupt(path: str, reason) -> None:
    warnings.warn(f"skipping corrupt checkpoint {path}: {reason}")
    if _metrics_mod.enabled():
        _M_CORRUPT.inc()


def latest_valid(dirname: str, prefix: str = "ckpt") -> Optional[str]:
    """Newest checkpoint that passes verification; corrupt files are
    skipped with a warning + metric instead of crashing the resume."""
    for step, path in _step_files(dirname, prefix):
        ok, reason = verify(path)
        if ok:
            return path
        _note_corrupt(path, reason)
    return None


def load_latest_valid(dirname: str, prefix: str = "ckpt",
                      mesh=None, valid_only: Optional[bool] = None
                      ) -> Optional[Tuple[Any, int, str]]:
    """(state, step, path) from the newest checkpoint that decodes cleanly,
    or None. Each candidate is read and CRC-verified once (the decode
    reuses the bytes). Corrupt candidates warn, count, and fall through to
    the next-newest. With `valid_only` (default: the
    PADDLE_TPU_RESUME_VALID_ONLY knob), candidates whose weights hold
    NaN/Inf are skipped the same way."""
    _no_mesh(mesh)
    if valid_only is None:
        valid_only = resume_valid_only()
    for step, path in _step_files(dirname, prefix):
        try:
            with open(path, "rb") as f:
                data = f.read()
            blob = _decode(path, data)
        except (OSError, CheckpointCorruptError) as e:
            _note_corrupt(path, e)
            continue
        state = to_torch(blob["state"])
        if valid_only and not tree_finite(state):
            _note_nonfinite_skip(path)
            continue
        if _metrics_mod.enabled():
            _M_LOADS.inc()
        return state, step, path
    return None


def cleanup_tmp(dirname: str, prefix: str = "ckpt") -> int:
    """Remove orphaned `<prefix>_*.tmp.*` files left by crashed writers."""
    if not os.path.isdir(dirname):
        return 0
    removed = 0
    for fn in os.listdir(dirname):
        if fn.startswith(prefix + "_") and ".tmp." in fn:
            try:
                os.remove(os.path.join(dirname, fn))
                removed += 1
            except OSError:
                pass
    if removed and _metrics_mod.enabled():
        _M_GC.inc(removed)
    return removed


class CheckpointCoordinator:
    """The reference's two-phase coordinated commit over a TCPStore (all
    hosts publish step N, or none do). Not ported yet: constructing one
    raises."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"CheckpointCoordinator: coordinated multi-host commits wait "
            f"for {_A11}")


def coordinator_from_env(timeout: Optional[float] = None,
                         resume_timeout: Optional[float] = None):
    """None for a single-host job (or with ``PADDLE_TPU_CKPT_BARRIER=0``),
    as in the reference; a multi-host environment (PADDLE_TRAINERS_NUM >=
    2 with MASTER_ADDR/MASTER_PORT) raises until A11 lands."""
    if os.environ.get("PADDLE_TPU_CKPT_BARRIER", "1") == "0":
        return None
    try:
        world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    except ValueError:
        return None
    if world < 2 or not os.environ.get("MASTER_ADDR") \
            or not os.environ.get("MASTER_PORT"):
        return None
    raise NotImplementedError(
        f"PADDLE_TRAINERS_NUM={world}: a multi-host checkpoint barrier "
        f"waits for {_A11}; set PADDLE_TPU_CKPT_BARRIER=0 to save per host")


def detect_layout(dirname: str, prefix: str = "ckpt") -> Optional[str]:
    """What checkpoint layout lives in `dirname`: "sharded" (step
    DIRECTORIES, the chunked layout), "file" (monolithic
    `<prefix>_<step>` files), or None (empty/fresh directory). A directory
    holding both resolves to the layout of the newest step; a tie
    prefers "sharded", as in the reference."""
    entries = _step_entries(dirname, prefix)
    files = [(s, p) for s, p in entries if not os.path.isdir(p)]
    dirs = [(s, p) for s, p in entries if os.path.isdir(p)]
    if not files and not dirs:
        return None
    if not dirs:
        return "file"
    if not files:
        return "sharded"
    return "file" if files[0][0] > dirs[0][0] else "sharded"


def open_manager(dirname: str, layout: str = "auto", prefix: str = "ckpt",
                 **kw) -> "CheckpointManager":
    """Build the CheckpointManager for `dirname`: "file" (monolithic
    per-host pickles), "sharded" (the chunked shared-directory layout,
    not ported yet: raises), or "auto" (detect from disk, "file" for a
    fresh directory)."""
    if layout == "auto":
        layout = detect_layout(dirname, prefix) or "file"
    if layout == "sharded":
        raise NotImplementedError(
            f"{dirname}: the sharded checkpoint layout waits for {_A11}")
    if layout != "file":
        raise ValueError(f"unknown checkpoint layout {layout!r} "
                         f"(expected 'file', 'sharded' or 'auto')")
    return CheckpointManager(dirname, prefix=prefix, **kw)


class CheckpointManager:
    """Stepped checkpoints with GC, corruption-tolerant resume, and a
    preemption hook.

    usage::

        mgr = CheckpointManager(dir, keep_last_n=3)
        mgr.install_preemption_handler(lambda: capture_state())
        ...
        mgr.save(state, step=it)                 # atomic, CRC'd, GC'd
        ...
        restored = mgr.load_latest()             # (state, step) or None
    """

    layout = "file"

    def __init__(self, dirname: str, prefix: str = "ckpt",
                 keep_last_n: int = 5, async_save: bool = False,
                 mesh=None, coordinator=None, store=None, rank: int = 0,
                 world_size: int = 1,
                 barrier_timeout: Optional[float] = None):
        if coordinator is not None or (store is not None
                                       and int(world_size) > 1):
            raise NotImplementedError(
                f"CheckpointManager across hosts waits for {_A11}")
        _no_mesh(mesh)
        self.dirname = str(dirname)
        self.prefix = prefix
        self.keep_last_n = max(1, int(keep_last_n))
        self.async_save = async_save
        self.mesh = None
        self.coordinator = None
        self._prev_sigterm = None
        self._preempt_state_fn: Optional[Callable[[], Any]] = None
        self._last_step: Optional[int] = None
        os.makedirs(self.dirname, exist_ok=True)
        if not _pending_saves:  # crashed predecessors only — never a tmp
            cleanup_tmp(self.dirname, self.prefix)  # still being written

    def path_for(self, step: int) -> str:
        return os.path.join(self.dirname, f"{self.prefix}_{int(step)}")

    def steps(self) -> List[int]:
        return [s for s, _ in _step_files(self.dirname, self.prefix)]

    def save(self, state: Any, step: int) -> bool:
        """Publish one checkpoint (atomic, CRC'd), then GC. Returns True
        (the reference returns False only for an aborted multi-host
        round)."""
        save(state, self.path_for(step), async_save=self.async_save)
        self._last_step = int(step)
        self.gc()
        return True

    def gc(self) -> int:
        """Keep the newest `keep_last_n` checkpoints; drop the rest and any
        orphaned tmp files. The tmp sweep only runs while no async save is
        in flight — a live writer's tmp file is not an orphan."""
        removed = 0
        if not _pending_saves:
            removed = cleanup_tmp(self.dirname, self.prefix)
        for step, path in _step_files(self.dirname, self.prefix)[
                self.keep_last_n:]:
            try:
                os.remove(path)
                removed += 1
                if _metrics_mod.enabled():
                    _M_GC.inc()
            except OSError:
                pass
        return removed

    def drain(self):
        """Block until every background save is published; re-raises the
        first background failure. Call at the end of training: the async
        writer is a daemon thread."""
        wait_all()

    def latest_valid_path(self) -> Optional[str]:
        if self.async_save:
            wait_all()  # a half-written newest file must finish publishing
        return latest_valid(self.dirname, self.prefix)

    def load_latest(self) -> Optional[Tuple[Any, int]]:
        """(state, step) from the newest VALID checkpoint, or None."""
        # drain in-process async saves unconditionally: another writer (a
        # prior fit's callback) may still be publishing into this directory
        wait_all()
        found = load_latest_valid(self.dirname, self.prefix)
        if found is None:
            return None
        state, step, _ = found
        return state, step

    # -- preemption ---------------------------------------------------------
    def install_preemption_handler(self, state_fn: Callable[[], Any],
                                   step_fn: Optional[Callable[[], int]] = None):
        """On SIGTERM (the preemption signal) perform ONE final synchronous
        save of `state_fn()` at step `step_fn()` before exiting. Chains any
        previously installed handler; without one, exits 143."""
        self._preempt_state_fn = state_fn
        self._preempt_step_fn = step_fn

        def handler(signum, frame):
            try:
                step = step_fn() if step_fn is not None else \
                    (self._last_step or 0) + 1
                # synchronous even if the manager is async: the process is
                # about to die, a background thread would be reaped mid-write
                save(state_fn(), self.path_for(step), async_save=False)
                self._last_step = int(step)
                if _metrics_mod.enabled():
                    _M_PREEMPT.inc()
            except Exception as e:
                warnings.warn(f"preemption save failed: {e}")
            prev = self._prev_sigterm
            if callable(prev):
                prev(signum, frame)
            else:
                raise SystemExit(143)

        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM, handler)
        except ValueError:  # not in the main thread: caller keeps polling
            self._prev_sigterm = None
            return False
        return True

    def uninstall_preemption_handler(self):
        if self._preempt_state_fn is None:
            return
        self._preempt_state_fn = None
        try:
            signal.signal(signal.SIGTERM,
                          self._prev_sigterm or signal.SIG_DFL)
        except ValueError:
            pass
        self._prev_sigterm = None
