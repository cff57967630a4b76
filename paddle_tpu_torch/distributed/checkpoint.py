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
lacks). Across hosts (ranks), ``CheckpointCoordinator`` runs the
reference's two-phase commit over the port's ``TCPStore`` (the store
``init_parallel_env`` rendezvoused on): every rank publishes step N or
none does, and ``load_latest`` resumes from the step every rank
committed. ``coordinator_from_env`` builds one from the trainer env
contract when ``PADDLE_TRAINERS_NUM`` >= 2. The sharded layout
(``layout="sharded"``, PTSHARD01) and restore onto a mesh belong with
ZeRO and tensor parallelism and raise, naming that item.
"""
from __future__ import annotations

import os
import signal
import struct
import threading
import time
import warnings
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..framework.io import _atomic_write, _dumps, _loads, to_host, to_torch
from ..profiler import events as _events_mod
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
_M_BARRIER_WAIT = _REG.histogram(
    "ckpt_barrier_wait_seconds",
    "time spent waiting for every host to prepare a coordinated checkpoint")
_M_BARRIER_ABORTS = _REG.counter(
    "ckpt_barrier_aborts_total",
    "coordinated checkpoint rounds aborted (no host published a final "
    "file), labeled by reason: timeout / peer_abort / error")
_M_BARRIER_COMMITS = _REG.counter(
    "ckpt_barrier_commits_total",
    "coordinated checkpoint commits (this host renamed tmp -> final after "
    "all hosts prepared)")

_pending_saves: list = []
_save_errors: list = []

# header: magic(8) | crc32(payload)(4, LE) | payload_len(8, LE)
_MAGIC = b"PTCKPT01"
_HEADER_FMT = struct.Struct("<8sIQ")

_SHARDED = "ROADMAP A11 (ZeRO/sharding with the sharded checkpoint)"


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
            f"checkpoint restore onto a mesh: re-sharding waits for {_SHARDED}")


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
    """Two-phase coordinated commit over a TCPStore: all hosts publish
    step N, or none do.

    Protocol (per step, every host):

    1. **prepare** — write the full CRC'd payload to ``<final>.tmp.prep``
       (durable, fsync'd; invisible to ``latest_valid``/``_step_files``).
    2. **commit** — publish a per-host "prepared" key, wait until all
       ``world_size`` hosts have published (bounded by ``timeout``), then
       atomically rename tmp -> final (the last in-phase step). A host that
       times out — or fails anywhere in the commit phase — publishes an
       abort flag instead, which every other host's wait loop observes, so
       the whole fleet drops its tmp and nobody publishes a final file.

    The fault site ``ckpt.commit`` sits at the top of the commit phase: a
    host killed there has a durable tmp but never voted, so its peers time
    out and abort — the exact "died between prepare and commit" failure.

    Residual window (two-generals): a host that dies AFTER the barrier
    opened but BEFORE its own rename leaves peers that already renamed.
    ``negotiate_resume`` closes it at restart: every host publishes its
    newest locally-committed step and the fleet resumes from the minimum —
    the newest step committed *everywhere* — never the lexically newest
    file of any single host.

    Keys are namespaced by ``PADDLE_TPU_ELASTIC_RESTART_NUM`` (an elastic
    supervisor's restart count) so a restarted generation's rounds can never
    collide with stale prepare/abort flags from the incarnation that died.
    Within a generation every ``commit()`` call additionally consumes a
    monotonically increasing round id (hosts call ``commit`` in lockstep —
    the same save sequence on every host, like ``negotiate_resume``), so a
    re-used *step number* (an epoch-end save followed by a SIGTERM
    preemption save before the next step, or a step retried after an
    aborted round) gets a fresh barrier instead of being decided by the
    previous round's stale votes or abort flag.
    Resolved rounds' store keys are garbage-collected with a lag of
    ``GC_LAG`` rounds: when round R resolves (commit or abort), each host
    deletes its OWN prep key and the abort flag of round R-2 — lockstep
    guarantees nobody can still be reading that round — so flags no longer
    accrete in the master store for the job's lifetime (same rule for
    resume-negotiation keys).

    Give the coordinator its own store client connection (a
    ``TCPStore(host, port)`` of its own), as in the reference.

    Every host (rank) MUST use its own checkpoint directory: the barrier
    coordinates *steps*, not storage, and hosts sharing one directory
    would clobber each other's fixed-name ``.tmp.prep``, race the final
    rename, and GC each other's in-flight tmps (the sharded layout, which
    shares one directory, is not ported).
    """

    def __init__(self, store, rank: int, world_size: int,
                 timeout: Optional[float] = None,
                 resume_timeout: Optional[float] = None,
                 namespace: Optional[str] = None,
                 poll_interval: float = 0.05):
        if world_size < 2:
            raise ValueError("CheckpointCoordinator needs world_size >= 2; "
                             "single-host saves do not barrier")
        self.store = store
        self.rank = int(rank)
        self.world_size = int(world_size)
        from ..utils.envparse import env_float
        if timeout is None:
            timeout = env_float("PADDLE_TPU_CKPT_BARRIER_TIMEOUT", 60.0)
        self.timeout = float(timeout)
        if resume_timeout is None:
            resume_timeout = env_float("PADDLE_TPU_CKPT_RESUME_TIMEOUT",
                                       max(self.timeout, 120.0))
        # resume negotiation tolerates much more skew than a save barrier:
        # restarted hosts arrive staggered by backoff + process startup +
        # jit warmup, while mid-training saves are lockstep
        self.resume_timeout = float(resume_timeout)
        if namespace is None:
            namespace = "ckptbar/" + os.environ.get(
                "PADDLE_TPU_ELASTIC_RESTART_NUM", "0")
        self.namespace = namespace
        self.poll_interval = float(poll_interval)
        self._resume_round = 0
        self._commit_round = 0
        self._round_steps: Dict[int, int] = {}  # round id -> step (for GC)

    def _k(self, *parts) -> str:
        return "/".join((self.namespace,) + tuple(str(p) for p in parts))

    # -- store-key GC --------------------------------------------------------
    GC_LAG = 2  # rounds a resolved round's keys outlive it

    def _gc_round_keys(self, finished_round: int):
        """Lag-2 deletion of this host's OWN keys for a long-resolved
        round, so prep/abort flags stop accreting in the master store for
        the job's lifetime. Safe by lockstep on the COMMIT path:
        completing round R with all votes proves every host voted in R,
        hence left round R-1 — nobody can still be reading round R-2's
        keys. On a TIMEOUT path a host lagging two full rounds behind
        could miss a just-deleted R-2 abort flag and burn its own timeout
        before aborting — the same abort outcome, reached slowly, never a
        torn commit. Best-effort: a failed delete costs memory on the
        master, never correctness."""
        r = finished_round - self.GC_LAG
        step = self._round_steps.pop(r, None)
        if step is None:
            return
        for key in (self._k("prep", r, step, self.rank),
                    self._k("abort", r, step)):
            try:
                self.store.delete_key(key)
            except Exception:
                pass

    def _gc_resume_keys(self, finished_round: int):
        """Same lag-2 rule for resume-negotiation keys."""
        r = finished_round - self.GC_LAG
        if r < 1:  # resume rounds start at 1
            return
        for key in (self._k("resume", r, self.rank),
                    self._k("resume_abort", r)):
            try:
                self.store.delete_key(key)
            except Exception:
                pass

    def _wait_keys(self, keys, deadline: float,
                   abort_key: Optional[str] = None) -> str:
        """Poll until every key exists -> 'ok'; abort flag -> 'abort';
        deadline -> 'timeout'."""
        missing = list(keys)
        while True:
            if abort_key is not None and self.store.check(abort_key):
                return "abort"
            missing = [k for k in missing if not self.store.check(k)]
            if not missing:
                return "ok"
            if time.time() >= deadline:
                return "timeout"
            time.sleep(self.poll_interval)

    def mark_abort(self, step: int, reason: str,
                   round_id: Optional[int] = None):
        """Publish the abort flag for `step` (best effort) and count it.
        `round_id` defaults to the round the NEXT local `commit()` would
        run — the right value for a host poisoning a round it has not
        entered itself (commit passes its own round explicitly)."""
        if round_id is None:
            round_id = self._commit_round
        self._round_steps.setdefault(int(round_id), int(step))
        try:
            self.store.set(self._k("abort", int(round_id), int(step)), reason)
        except Exception:
            pass  # store gone: peers will hit their own timeout
        if _metrics_mod.enabled():
            _M_BARRIER_ABORTS.inc(reason=reason)
        _events_mod.emit("barrier_abort", severity="warn", step=int(step),
                         round=int(round_id), reason=reason)

    def abort_next_round(self, step: int, reason: str = "error"):
        """Poison and CONSUME the round this host would run for `step` —
        for failures BEFORE commit() was entered (prepare-phase errors).
        Peers already in commit() for this step observe a prompt abort
        instead of burning the barrier timeout, and if this host survives
        and keeps training its round counter stays lockstep with the
        fleet's (otherwise every later save would land on a stale round)."""
        round_id = self._commit_round
        self._commit_round += 1
        self.mark_abort(step, reason, round_id)

    def commit(self, step: int, publish_fn: Callable[[], None]) -> bool:
        """Run the commit phase for `step`; `publish_fn` performs the local
        atomic rename. True = committed everywhere we can observe; False =
        aborted (caller must GC its tmp). Raises whatever `publish_fn` or
        the store raises after flagging the abort for the peers."""
        from ..fault import site as _fault_site
        step = int(step)
        # one round id per commit() call, consumed even on abort — hosts
        # run the same save sequence, so a re-used step number can never
        # see a previous round's votes or abort flag
        round_id = self._commit_round
        self._commit_round += 1
        self._round_steps[round_id] = step
        abort_key = self._k("abort", round_id, step)
        try:
            # a kill injected here (host dies between prepare and commit)
            # has a durable tmp but never votes NOR flags: peers time out
            # and abort, and no final file appears anywhere. A non-fatal
            # failure anywhere in the phase flags the abort below so peers
            # observe a prompt peer_abort instead of burning the timeout.
            _fault_site("ckpt.commit")
            self.store.set(self._k("prep", round_id, step, self.rank), "1")
            prep_keys = [self._k("prep", round_id, step, r)
                         for r in range(self.world_size)]
            t0 = time.perf_counter()
            outcome = self._wait_keys(prep_keys, time.time() + self.timeout,
                                      abort_key)
            if _metrics_mod.enabled():
                _M_BARRIER_WAIT.observe(time.perf_counter() - t0)
            if outcome != "ok":
                reason = "peer_abort" if outcome == "abort" else "timeout"
                self.mark_abort(step, reason, round_id)
                self._gc_round_keys(round_id)
                return False
            if self.store.check(abort_key):
                # a slower host timed out after we saw all votes: honor it
                self.mark_abort(step, "peer_abort", round_id)
                self._gc_round_keys(round_id)
                return False
            # publish_fn is the LAST in-phase operation: anything after the
            # rename that could fail would mark_abort a round this host has
            # already committed on disk — peers would GC their prepared
            # tmps and the fleet's newest-committed steps would diverge
            publish_fn()
        except BaseException:
            self.mark_abort(step, "error", round_id)
            raise
        if _metrics_mod.enabled():
            _M_BARRIER_COMMITS.inc()
        _events_mod.emit("barrier_commit", step=step, round=round_id)
        self._gc_round_keys(round_id)
        return True

    def negotiate_resume(self, local_step: Optional[int]) -> Optional[int]:
        """Fleet agreement on the resume step: publish this host's newest
        locally-valid committed step, wait for every host, return the
        minimum — the newest step that exists on ALL hosts. Returns None
        (fresh start) when any host has nothing. Hosts must call this in
        lockstep (same number of times per generation).

        Consistency over availability: a wait timeout poisons the round
        (abort flag) and RAISES. Falling back to the local step here would
        split-brain the fleet — a peer arriving just past the deadline
        finds every key present, resumes the fleet minimum, and trains
        against this host's different parameters with no error anywhere.
        A fleet that cannot assemble within the deadline cannot train
        (collectives need every host), so failing loudly and letting the
        launcher's restart budget drive relaunch is strictly safer."""
        self._resume_round += 1
        abort_key = self._k("resume_abort", self._resume_round)
        mine = -1 if local_step is None else int(local_step)
        self.store.set(self._k("resume", self._resume_round, self.rank),
                       str(mine))
        keys = [self._k("resume", self._resume_round, r)
                for r in range(self.world_size)]
        outcome = self._wait_keys(keys, time.time() + self.resume_timeout,
                                  abort_key)
        if outcome != "ok" or self.store.check(abort_key):
            try:
                self.store.set(abort_key, "timeout")
            except Exception:
                pass  # store gone: peers hit their own timeout
            raise RuntimeError(
                f"checkpoint resume negotiation "
                f"{'abandoned by a peer' if outcome == 'abort' else 'timed out'}"
                f" after {self.resume_timeout}s waiting for "
                f"{self.world_size} hosts (rank {self.rank}); refusing to "
                f"fall back to a local step — peers that did assemble "
                f"would resume a different one. Relaunch the fleet "
                f"together (the launcher's restarts do this).")
        steps = [int(self.store.get(k).decode()) for k in keys]
        self._gc_resume_keys(self._resume_round)
        if any(s < 0 for s in steps):
            return None
        return min(steps)


def coordinator_from_env(timeout: Optional[float] = None,
                         resume_timeout: Optional[float] = None
                         ) -> Optional[CheckpointCoordinator]:
    """Build a CheckpointCoordinator from the standard trainer env contract
    (PADDLE_TRAINERS_NUM / PADDLE_TRAINER_ID / MASTER_ADDR / MASTER_PORT —
    what `paddle_tpu_torch.distributed.launch` and `spawn` export), or None
    for single-host jobs / when `PADDLE_TPU_CKPT_BARRIER=0`.

    Opens its OWN client connection to the store rank 0 hosts for
    ``init_parallel_env``."""
    if os.environ.get("PADDLE_TPU_CKPT_BARRIER", "1") == "0":
        return None
    try:
        world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    except ValueError:
        return None
    if world < 2 or not os.environ.get("MASTER_ADDR") \
            or not os.environ.get("MASTER_PORT"):
        return None
    try:
        port = int(os.environ["MASTER_PORT"])
    except ValueError:
        # NOT a silent degrade: PADDLE_TRAINERS_NUM says this host is part
        # of a >=2 fleet, so quietly returning None would disable the
        # checkpoint barrier on this host alone while its peers wait on it
        raise ValueError(
            f"MASTER_PORT={os.environ['MASTER_PORT']!r} is not a port "
            f"number but PADDLE_TRAINERS_NUM={world} expects a coordinated "
            f"fleet; fix the launcher env "
            f"or set PADDLE_TPU_CKPT_BARRIER=0 to opt out of the barrier")
    try:
        rank = int(os.environ["PADDLE_TRAINER_ID"])
    except (KeyError, ValueError):
        # defaulting to rank 0 here would have EVERY host of the fleet
        # publish prepare votes as rank 0 and wait forever for the others:
        # each coordinated save burns the barrier timeout with no message
        # naming the real cause
        raise ValueError(
            f"PADDLE_TRAINER_ID={os.environ.get('PADDLE_TRAINER_ID')!r} "
            f"but PADDLE_TRAINERS_NUM={world} expects a coordinated fleet; "
            f"every host needs a distinct rank "
            f"or set PADDLE_TPU_CKPT_BARRIER=0 to "
            f"opt out of the barrier")
    from .store import TCPStore
    store = TCPStore(os.environ["MASTER_ADDR"], port, is_master=False)
    return CheckpointCoordinator(store, rank, world, timeout=timeout,
                                 resume_timeout=resume_timeout)


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
            f"{dirname}: the sharded checkpoint layout waits for {_SHARDED}")
    if layout != "file":
        raise ValueError(f"unknown checkpoint layout {layout!r} "
                         f"(expected 'file', 'sharded' or 'auto')")
    return CheckpointManager(dirname, prefix=prefix, **kw)


class CheckpointManager:
    """Stepped checkpoints with GC, corruption-tolerant resume, and a
    preemption hook; across ranks, the coordinated two-phase commit.

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
                 mesh=None, coordinator: Optional[CheckpointCoordinator] = None,
                 store=None, rank: int = 0, world_size: int = 1,
                 barrier_timeout: Optional[float] = None):
        _no_mesh(mesh)
        self.dirname = str(dirname)
        self.prefix = prefix
        self.keep_last_n = max(1, int(keep_last_n))
        self.async_save = async_save
        self.mesh = None
        if coordinator is None and store is not None and int(world_size) > 1:
            coordinator = CheckpointCoordinator(store, rank, world_size,
                                                timeout=barrier_timeout)
        # world_size == 1 degrades to the plain local save — no barrier
        self.coordinator = coordinator
        if coordinator is not None and self.keep_last_n < 2:
            # one step of commit skew between hosts is inherent to the
            # two-generals window: a host that renamed step N just before
            # the fleet died negotiates resume at N-1, which keep_last_n=1
            # would already have deleted here
            self.keep_last_n = 2
        self._prev_sigterm = None
        self._preempt_state_fn: Optional[Callable[[], Any]] = None
        self._last_step: Optional[int] = None
        self._save_in_flight = False
        os.makedirs(self.dirname, exist_ok=True)
        if not _pending_saves:  # crashed predecessors only — never a tmp
            cleanup_tmp(self.dirname, self.prefix)  # still being written

    def path_for(self, step: int) -> str:
        return os.path.join(self.dirname, f"{self.prefix}_{int(step)}")

    def steps(self) -> List[int]:
        return [s for s, _ in _step_files(self.dirname, self.prefix)]

    def save(self, state: Any, step: int) -> bool:
        """Publish one checkpoint: the coordinated two-phase commit when a
        coordinator is configured, the plain atomic save otherwise; then
        GC. False when a coordinated round aborted (the checkpoint was
        skipped on every rank); training should continue."""
        if self.coordinator is not None:
            committed = self._save_coordinated(state, step)
        else:
            save(state, self.path_for(step), async_save=self.async_save)
            committed = True
        self._last_step = int(step)
        self.gc()
        return committed

    def _save_coordinated(self, state: Any, step: int) -> bool:
        """Two-phase commit of step N: a durable tmp (prepare), then the
        coordinator's all-or-nothing rename (commit). Always synchronous:
        a barrier over a background write would publish a file the fleet
        already voted on while this host could still fail the write."""
        # the in-flight flag covers the WHOLE save, prepare included: a
        # SIGTERM during the tmp write re-entering a nested coordinated
        # save would consume a round id peers spend on a different step
        self._save_in_flight = True
        try:
            final = self.path_for(step)
            tmp = final + ".tmp.prep"
            try:
                t0 = time.perf_counter()
                header, payload = _encode({"state": _to_host(state),
                                           "specs": {}, "version": 2})
                with open(tmp, "wb") as f:
                    f.write(header)
                    f.write(payload)
                    f.flush()
                    os.fsync(f.fileno())
            except BaseException:
                # prepare failed (disk full, SIGTERM-driven SystemExit):
                # poison + consume this host's round so peers abort
                # promptly and this host stays round-lockstep
                self.coordinator.abort_next_round(step)
                self._rm_quiet(tmp)
                raise
            # write time only: the commit wait is ckpt_barrier_wait_seconds
            write_secs = time.perf_counter() - t0
            try:
                committed = self.coordinator.commit(
                    step, lambda: os.replace(tmp, final))
            except BaseException:
                # commit() already flagged the abort for the peers
                self._rm_quiet(tmp)
                raise
            if not committed:
                self._rm_quiet(tmp)
                warnings.warn(
                    f"coordinated checkpoint step {int(step)} aborted — "
                    f"not every host prepared in time; no host published a "
                    f"final file for this step (see "
                    f"ckpt_barrier_aborts_total)")
                return False
            if _metrics_mod.enabled():
                _M_SAVES.inc()
                _M_SAVE_SECONDS.observe(write_secs)
            return True
        finally:
            self._save_in_flight = False

    @staticmethod
    def _rm_quiet(path: str):
        try:
            os.remove(path)
        except OSError:
            pass

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

    def _local_latest_valid(self) -> Tuple[Optional[int], Optional[dict]]:
        """(step, decoded blob) of the newest locally-valid checkpoint, or
        (None, None); under valid-only resume, CRC-valid blobs holding
        NaN/Inf are walked past too."""
        valid_only = resume_valid_only()
        for step, path in _step_files(self.dirname, self.prefix):
            try:
                with open(path, "rb") as f:
                    blob = _decode(path, f.read())
            except (OSError, CheckpointCorruptError) as e:
                _note_corrupt(path, e)
                continue
            if valid_only and not tree_finite(blob.get("state")):
                _note_nonfinite_skip(path)
                continue
            return step, blob
        return None, None

    def load_latest(self) -> Optional[Tuple[Any, int]]:
        """(state, step) from the newest VALID checkpoint, or None.
        Coordinated managers negotiate first: every rank resumes from the
        newest step committed on EVERY rank, never its own newest file."""
        # drain in-process async saves unconditionally: another writer (a
        # prior fit's callback) may still be publishing into this directory
        wait_all()
        if self.coordinator is not None:
            local_step, local_blob = self._local_latest_valid()
            agreed = self.coordinator.negotiate_resume(local_step)
            if agreed is None:
                return None
            blob = (local_blob if agreed == local_step
                    else self._read_agreed(agreed))
            if _metrics_mod.enabled():
                _M_LOADS.inc()
            return to_torch(blob["state"]), agreed
        found = load_latest_valid(self.dirname, self.prefix)
        if found is None:
            return None
        state, step, _ = found
        return state, step

    def _read_agreed(self, agreed: int) -> dict:
        """Read the fleet-agreed resume step when it is NOT this host's
        newest valid file (a peer was behind). Never falls back locally:
        peers restore the agreed step, and a different one here would be
        averaged into the run by the data-parallel all-reduce."""
        path = self.path_for(agreed)
        try:
            with open(path, "rb") as f:
                blob = _decode(path, f.read())
        except (OSError, CheckpointCorruptError) as e:
            if _metrics_mod.enabled():
                _M_CORRUPT.inc()
            raise CheckpointCorruptError(
                path,
                f"fleet-agreed resume step {agreed} is unreadable on "
                f"this host ({e}); refusing to diverge from peers that "
                f"can read it") from e
        if resume_valid_only() and not tree_finite(blob.get("state")):
            if _metrics_mod.enabled():
                _M_SKIP_NONFINITE.inc()
            raise CheckpointCorruptError(
                path,
                f"fleet-agreed resume step {agreed} holds nonfinite "
                f"weights on this host under valid-only resume")
        return blob

    def _publish_sync(self, state: Any, step: int) -> bool:
        """One synchronous publish through the configured path (the
        coordinated commit when a coordinator is present: a preemption
        SIGTERMs every rank at once, so the final save barriers too)."""
        if self.coordinator is not None:
            return self._save_coordinated(state, step)
        save(state, self.path_for(step), async_save=False)
        return True

    # -- preemption ---------------------------------------------------------
    def install_preemption_handler(self, state_fn: Callable[[], Any],
                                   step_fn: Optional[Callable[[], int]] = None):
        """On SIGTERM (the preemption signal) perform ONE final synchronous
        save of `state_fn()` at step `step_fn()` before exiting, through
        the coordinated barrier when configured. Chains any previously
        installed handler; without one, exits 143."""
        self._preempt_state_fn = state_fn
        self._preempt_step_fn = step_fn

        def handler(signum, frame):
            if self.coordinator is not None and self._save_in_flight:
                # SIGTERM inside an in-flight coordinated save: a nested
                # save would consume a second round id mid-round; the
                # SystemExit below unwinds the in-flight save, which flags
                # a prompt abort for the peers
                warnings.warn("preemption during an in-flight coordinated "
                              "save: skipping the final preemption save "
                              "(resume uses the newest committed step)")
            else:
                try:
                    step = step_fn() if step_fn is not None else \
                        (self._last_step or 0) + 1
                    # synchronous even if the manager is async: the process
                    # is about to die, a background thread would be reaped
                    if self._publish_sync(state_fn(), step):
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
