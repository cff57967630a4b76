"""Sharded, chunked, asynchronous checkpoint (counterpart of
``paddle_tpu/distributed/sharded_checkpoint.py``), in the reference's
on-disk format (magic ``PTSHARD01``): a step directory written by either
package loads in the other.

* **Format.** A step is a directory ``<prefix>_<step>/`` holding one
  raw-bytes file a chunk of an array and one JSON manifest a rank. Every
  manifest records the whole tree, each array's global shape, dtype and
  PartitionSpec, the world size, and the CRC32 and length of each chunk
  that rank wrote. Chunk files and manifests are named by rank,
  generation and attempt, so ranks sharing one directory never clobber
  each other.
* **What a rank writes.** A ``sharding.ShardedTensor`` (this rank's piece
  of an array, with its box: the form ZeRO's slots, and its parameters at
  stage 3, take) is written by its rank as one chunk. An array every rank
  holds whole is written once, by ``owner_rank(path, world)``.
* **Asynchronous save.** ``ShardedCheckpointManager.save`` copies the
  state to the host synchronously, then a bounded background writer
  writes it while training goes on (at most one snapshot queued; its
  failures surface on ``drain``). A coordinated save runs its two-phase
  commit (``checkpoint.CheckpointCoordinator``) on the writer thread,
  after the write; after each commit a rank mirrors its peer's manifest.
* **Re-sharding restore.** ``load_step(step_dir, mesh=group)`` rebuilds
  each array for this rank of ``group`` (the port's counterpart of the
  reference's mesh, under the same name): an array whose spec names the
  group's axis comes back as this rank's ShardedTensor, read from the
  chunks that overlap its box only; an axis the group lacks warns loudly
  and replicates. Without a group every array comes back whole. A step
  written on one world size restores onto another through this one path.

Arrays come back as CPU torch tensors (numpy for the types torch lacks).
A pickled leaf (``__ptpickle__``) is read by ``framework/io.py``'s
rules, so a pickle naming ``jax``, ``jaxlib`` or ``paddle_tpu`` is
refused. Fault sites: ``ckpt.chunk_write`` (each chunk file; a writer
that dies mid-save aborts the barrier round at once) and
``ckpt.reshard`` (the restore's reassembly).
"""
from __future__ import annotations

import base64
import json
import os
import shutil
import threading
import time
import warnings
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..framework.io import _dumps, _loads
from ..profiler import metrics as _metrics_mod
from . import checkpoint as _ck
from .checkpoint import CheckpointCorruptError, CheckpointManager
from . import sharding as _zero
from .sharding import ShardedTensor

_REG = _metrics_mod.default_registry()
_M_ASYNC_PENDING = _REG.gauge(
    "checkpoint_async_pending",
    "background checkpoint saves queued or in flight on this host")
_M_ASYNC_BYTES = _REG.counter(
    "checkpoint_async_bytes",
    "bytes written to disk by the background checkpoint writer")
_M_ASYNC_SECONDS = _REG.histogram(
    "checkpoint_async_seconds",
    "wall time of background checkpoint writes (the cost hidden off the "
    "step critical path)")

MANIFEST_MAGIC = "PTSHARD01"
_MANIFEST_VERSION = 1
_MIRROR_SUFFIX = ".mirror"


def _manifest_name(rank: int) -> str:
    return f"manifest-r{int(rank)}.json"


def _mirror_name(rank: int) -> str:
    """Rank ``rank``'s manifest as its peer copies it after each commit:
    losing one owner's manifest leaves the step restorable."""
    return _manifest_name(rank) + _MIRROR_SUFFIX


def _parse_manifest_name(fn: str) -> Optional[int]:
    if fn.startswith("manifest-r") and fn.endswith(".json"):
        try:
            return int(fn[len("manifest-r"):-len(".json")])
        except ValueError:
            return None
    return None


def is_step_dir(path: str) -> bool:
    """Is ``path`` a step directory of this layout?"""
    if not os.path.isdir(path):
        return False
    try:
        return any(fn.startswith("manifest-r") or fn.endswith(".chunk")
                   for fn in os.listdir(path))
    except OSError:
        return False


# ---------------------------------------------------------------------------
# snapshot: device -> host, keeping each rank's piece
# ---------------------------------------------------------------------------
@dataclass
class _ArraySnap:
    shape: Tuple[int, ...]
    dtype: str
    spec: Optional[tuple]
    chunks: List[tuple] = field(default_factory=list)  # [(box, host data)]
    # False for a piece of an array spread over the ranks: its rank
    # writes it, and the single-owner rule of whole arrays does not apply
    fully_addressable: bool = True


@dataclass
class _Snapshot:
    tree: Any
    arrays: Dict[str, _ArraySnap]
    mesh_axes: Optional[Dict[str, int]] = None


def _box_volume(box) -> int:
    v = 1
    for a, b in box:
        v *= max(0, b - a)
    return v


def _whole_box(shape) -> List[List[int]]:
    return [[0, int(d)] for d in shape]


def _dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).replace("torch.", "")
    return str(t.dtype)


def _host(t):
    """A host copy the snapshot owns: numpy, or a CPU bf16 tensor. A
    card's tensor is copied into pinned memory without a wait (the
    snapshot waits once for all of them)."""
    if isinstance(t, np.ndarray):
        return np.array(t, copy=True)
    t = t.detach()
    if t.is_cuda:
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
    else:
        out = t.clone(memory_format=torch.contiguous_format)
    return out if out.dtype == torch.bfloat16 else out.numpy()


def _bytes(data) -> bytes:
    if isinstance(data, torch.Tensor):  # bf16: its bits
        return data.view(torch.int16).numpy().tobytes()
    return np.ascontiguousarray(data).tobytes()


def snapshot_tree(state: Any) -> _Snapshot:
    """Synchronous device→host copy of ``state``, keeping each piece's box
    (a card's tensors through pinned memory).

    A tensor or numpy array becomes one whole chunk; a ShardedTensor one
    chunk of its box; everything else lands in the JSON skeleton (other
    objects as a base64 pickle). The only part of a save on the step's
    thread: writing is the background writer's."""
    snap = _Snapshot(tree=None, arrays={})

    def walk(obj, prefix):
        if isinstance(obj, ShardedTensor):
            local = _host(obj.local)
            if snap.mesh_axes is None and obj.spec is not None:
                for i, p in enumerate(obj.spec):
                    if isinstance(p, str):
                        n = obj.shape[i] // max(1, obj.box[i][1]
                                                - obj.box[i][0])
                        snap.mesh_axes = {p: int(n)}
                        break
            snap.arrays[prefix] = _ArraySnap(
                shape=obj.shape, dtype=_dtype_name(local), spec=obj.spec,
                chunks=[(obj.box, local)], fully_addressable=obj.whole)
            return {"__ptarray__": prefix}
        if isinstance(obj, (torch.Tensor, np.ndarray)):
            data = _host(obj)
            snap.arrays[prefix] = _ArraySnap(
                shape=tuple(int(d) for d in obj.shape),
                dtype=_dtype_name(data), spec=None,
                chunks=[(_whole_box(obj.shape), data)])
            return {"__ptarray__": prefix}
        if isinstance(obj, dict):
            if all(isinstance(k, str) and not k.startswith("__pt")
                   for k in obj):
                return {k: walk(v, f"{prefix}/{k}") for k, v in obj.items()}
            return {"__ptdict__": [
                [walk(k, f"{prefix}/k{i}"), walk(v, f"{prefix}/{i}")]
                for i, (k, v) in enumerate(obj.items())]}
        if isinstance(obj, tuple):
            return {"__pttuple__": [walk(v, f"{prefix}/{i}")
                                    for i, v in enumerate(obj)]}
        if isinstance(obj, list):
            return [walk(v, f"{prefix}/{i}") for i, v in enumerate(obj)]
        if obj is None or isinstance(obj, (bool, int, float, str)):
            return obj
        return {"__ptpickle__": base64.b64encode(
            bytes(_dumps(obj))).decode("ascii")}

    snap.tree = walk(state, "")
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()  # the pinned copies have landed
    return snap


def _decode_tree(node, arrays: Dict[str, Any]):
    """Rebuild the tree from a manifest's skeleton and the arrays."""
    if isinstance(node, dict):
        if "__ptarray__" in node:
            return arrays[node["__ptarray__"]]
        if "__pttuple__" in node:
            return tuple(_decode_tree(v, arrays)
                         for v in node["__pttuple__"])
        if "__ptdict__" in node:
            return {_decode_tree(k, arrays): _decode_tree(v, arrays)
                    for k, v in node["__ptdict__"]}
        if "__ptpickle__" in node:
            return _loads(base64.b64decode(node["__ptpickle__"]))
        return {k: _decode_tree(v, arrays) for k, v in node.items()}
    if isinstance(node, list):
        return [_decode_tree(v, arrays) for v in node]
    return node


def _np_dtype(name: str) -> np.dtype:
    """The numpy type a chunk's bytes are read as (bf16 as its bits)."""
    if name == "bfloat16":
        return np.dtype(np.uint16)
    return np.dtype(name)


def _to_tensor(buf: np.ndarray, name: str):
    if name == "bfloat16":
        return torch.from_numpy(buf).view(torch.bfloat16)
    try:
        return torch.from_numpy(buf)
    except TypeError:  # a type torch does not hold
        return buf


def owner_rank(path: str, world_size: int) -> int:
    """The one rank that writes an array every rank holds whole."""
    return zlib.crc32(path.encode()) % max(1, int(world_size))


# ---------------------------------------------------------------------------
# write side
# ---------------------------------------------------------------------------
def _spec_to_json(spec):
    if spec is None:
        return None
    return [list(p) if isinstance(p, (tuple, list)) else p for p in spec]


def _spec_from_json(spec):
    if spec is None:
        return None
    return tuple(tuple(p) if isinstance(p, list) else p for p in spec)


def write_shards(step_dir: str, step: int, rank: int, world_size: int,
                 snap: _Snapshot, *, generation: Optional[int] = None,
                 attempt: int = 0) -> Tuple[str, int]:
    """The prepare phase: this rank's chunk files and its manifest as
    ``manifest-r<rank>.json.tmp.prep``, each fsync'd. Returns (the
    manifest's tmp path, bytes written). Nothing is visible to a reader
    until the manifest is renamed (the commit)."""
    from ..fault import site as _fault_site
    if generation is None:
        from ..utils.envparse import env_int
        generation = env_int("PADDLE_TPU_ELASTIC_RESTART_NUM", 0)
    os.makedirs(step_dir, exist_ok=True)
    rank, world_size = int(rank), max(1, int(world_size))
    suffix = f"g{int(generation)}a{int(attempt)}"
    chunk_records, arrays_meta = [], {}
    nbytes_total, seq = 0, 0
    for path in sorted(snap.arrays):
        a = snap.arrays[path]
        arrays_meta[path] = {"shape": list(a.shape), "dtype": a.dtype,
                             "spec": _spec_to_json(a.spec)}
        if a.fully_addressable and owner_rank(path, world_size) != rank:
            continue  # another rank writes this whole array
        for box, arr in a.chunks:
            fn = f"r{rank}-{seq:04d}.{suffix}.chunk"
            seq += 1
            data = _bytes(arr)
            _fault_site("ckpt.chunk_write")
            with open(os.path.join(step_dir, fn), "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            chunk_records.append({
                "file": fn, "path": path, "index": box,
                "crc32": zlib.crc32(data) & 0xFFFFFFFF, "bytes": len(data)})
            nbytes_total += len(data)
    manifest = {
        "magic": MANIFEST_MAGIC, "version": _MANIFEST_VERSION,
        "step": int(step), "rank": rank, "world_size": world_size,
        "generation": int(generation), "wall_time": time.time(),
        "mesh_axes": snap.mesh_axes, "tree": snap.tree,
        "arrays": arrays_meta, "chunks": chunk_records}
    tmp = os.path.join(step_dir, _manifest_name(rank) + ".tmp.prep")
    payload = json.dumps(manifest).encode()
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    return tmp, nbytes_total + len(payload)


# ---------------------------------------------------------------------------
# scan / verify
# ---------------------------------------------------------------------------
@dataclass
class StepScan:
    step_dir: str
    manifests: Dict[int, dict] = field(default_factory=dict)  # committed
    bad_manifests: List[Tuple[str, str]] = field(default_factory=list)
    tmp_manifests: List[str] = field(default_factory=list)
    world_size: Optional[int] = None
    #: ranks whose manifest came from the peer's ``.mirror`` copy
    mirrored: List[int] = field(default_factory=list)


def _read_manifest(path: str) -> dict:
    """Read and validate one committed manifest; raises on anything a
    reader could not trust."""
    with open(path, "rb") as f:
        m = json.loads(f.read().decode())
    if m.get("magic") != MANIFEST_MAGIC or "tree" not in m \
            or not isinstance(m.get("chunks"), list) \
            or not isinstance(m.get("arrays"), dict):
        raise ValueError("not a PTSHARD01 manifest")
    int(m["world_size"]), int(m["rank"])
    for rec in m["chunks"]:
        if not isinstance(rec, dict) or \
                not isinstance(rec["file"], str) or \
                not isinstance(rec["path"], str):
            raise ValueError("malformed chunk record")
        int(rec["bytes"]), int(rec["crc32"])
        [(int(a), int(b)) for a, b in rec["index"]]
    return m


def scan_step(step_dir: str) -> StepScan:
    """Every committed manifest of a step directory. Of manifests of
    different world sizes (a step number re-used after a resize) the
    newest group wins, by generation first and then wall time. A rank
    whose own manifest is missing or unreadable falls back to its peer's
    ``.mirror`` copy (``scan.mirrored``)."""
    scan = StepScan(step_dir=step_dir)
    if not os.path.isdir(step_dir):
        return scan
    groups: Dict[int, Dict[int, dict]] = {}
    mirror_groups: Dict[int, Dict[int, dict]] = {}
    for fn in sorted(os.listdir(step_dir)):
        if fn.endswith(".tmp.prep") and _parse_manifest_name(
                fn[:-len(".tmp.prep")]) is not None:
            scan.tmp_manifests.append(os.path.join(step_dir, fn))
            continue
        mirror = fn.endswith(_MIRROR_SUFFIX)
        rank = _parse_manifest_name(fn[:-len(_MIRROR_SUFFIX)]) if mirror \
            else _parse_manifest_name(fn)
        if rank is None:
            continue
        path = os.path.join(step_dir, fn)
        try:
            m = _read_manifest(path)
            world, rank_m = int(m["world_size"]), int(m["rank"])
        except (OSError, ValueError, KeyError, TypeError) as e:
            if not mirror:  # an unreadable mirror says nothing of the step
                scan.bad_manifests.append((path, f"{type(e).__name__}: {e}"))
            continue
        (mirror_groups if mirror else groups).setdefault(
            world, {})[rank_m] = m
    mirrored_by_world: Dict[int, List[int]] = {}
    for world, ms in mirror_groups.items():
        for rank_m, m in ms.items():
            if rank_m not in groups.get(world, {}):
                groups.setdefault(world, {})[rank_m] = m
                mirrored_by_world.setdefault(world, []).append(rank_m)
    if groups:
        def freshness(item):
            return max((int(m.get("generation", 0)),
                        float(m.get("wall_time", 0.0)))
                       for m in item[1].values())
        world, manifests = max(groups.items(), key=freshness)
        scan.world_size = world
        scan.manifests = manifests
        scan.mirrored = sorted(mirrored_by_world.get(world, []))
    return scan


def _chunk_ok(step_dir: str, rec: dict, deep: bool) -> Tuple[bool, str]:
    path = os.path.join(step_dir, rec["file"])
    try:
        size = os.path.getsize(path)
    except OSError:
        return False, f"{rec['file']}: missing"
    if size != int(rec["bytes"]):
        return False, (f"{rec['file']}: {size} bytes on disk, manifest "
                       f"says {rec['bytes']}")
    if deep:
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            return False, f"{rec['file']}: unreadable: {e}"
        if zlib.crc32(data) & 0xFFFFFFFF != int(rec["crc32"]):
            return False, f"{rec['file']}: CRC32 mismatch"
    return True, ""


def verify_step(step_dir: str, deep: bool = False) -> Tuple[str, str]:
    """(status, detail) of one step directory: ``complete`` (every
    manifest of its world committed, every chunk intact), ``partial``
    (manifests or chunks lost, but the intact chunks still cover every
    array), ``torn`` (only ``.tmp.prep`` manifests), ``corrupt`` (some
    array cannot be rebuilt) or ``empty``. ``deep`` CRC-checks every
    chunk; the default checks presence and length only."""
    scan = scan_step(step_dir)
    if not scan.manifests:
        if scan.tmp_manifests:
            return ("torn", f"{len(scan.tmp_manifests)} prepared "
                            f"manifest(s), none committed")
        if scan.bad_manifests:
            return "corrupt", scan.bad_manifests[0][1]
        return "empty", "no manifests"
    world = scan.world_size
    problems = []
    missing_ranks = sorted(set(range(world)) - set(scan.manifests))
    if missing_ranks:
        problems.append(f"missing manifest(s) for rank(s) {missing_ranks} "
                        f"of world {world}")
    if scan.mirrored:
        problems.append(f"rank(s) {scan.mirrored} recovered via "
                        f"peer-mirrored manifest(s)")
    any_manifest = next(iter(scan.manifests.values()))
    covered: Dict[str, int] = {p: 0 for p in any_manifest["arrays"]}
    for m in scan.manifests.values():
        for rec in m["chunks"]:
            ok, why = _chunk_ok(step_dir, rec, deep)
            if not ok:
                problems.append(why)
                continue
            covered[rec["path"]] = covered.get(rec["path"], 0) + \
                _box_volume(rec["index"])
    holes = [path for path, meta in any_manifest["arrays"].items()
             if covered.get(path, 0) < int(np.prod(meta["shape"],
                                                   dtype=np.int64))]
    if holes:
        return ("corrupt", f"array(s) {holes[:3]} cannot be reassembled "
                           f"({'; '.join(problems[:3]) or 'chunks lost'})")
    if problems:
        return "partial", "; ".join(problems[:4])
    return ("complete", f"world {world}, "
            f"{sum(len(m['chunks']) for m in scan.manifests.values())} "
            f"chunks")


# ---------------------------------------------------------------------------
# load side: reassembly and re-sharding
# ---------------------------------------------------------------------------
def _boxes_overlap(a, b) -> bool:
    return all(x0 < y1 and y0 < x1 for (x0, x1), (y0, y1) in zip(a, b))


def _read_chunk(step_dir: str, rec: dict, dtype: np.dtype) -> np.ndarray:
    """One chunk, CRC-checked, as an array of its box's shape."""
    path = os.path.join(step_dir, rec["file"])
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise CheckpointCorruptError(path, f"chunk unreadable: {e}")
    if len(data) != int(rec["bytes"]):
        raise CheckpointCorruptError(
            path, f"chunk truncated: {len(data)} bytes, manifest says "
                  f"{rec['bytes']}")
    if zlib.crc32(data) & 0xFFFFFFFF != int(rec["crc32"]):
        raise CheckpointCorruptError(
            path, f"chunk CRC32 mismatch (stored {int(rec['crc32']):#010x})")
    shape = tuple(b - a for a, b in rec["index"])
    return np.frombuffer(data, dtype=dtype).reshape(shape)


def _target_box(path, shape, spec, group):
    """(box this rank of ``group`` needs, spec it keeps): the spec's axis
    that ``group`` names cuts its dimension into ``group.nranks`` equal
    pieces; an axis the group lacks, or a dimension that does not divide,
    warns loudly and replicates. The ``sharding`` axis cuts where ZeRO's
    rule does for the group's size (``sharding.shard_dim``), which need
    not be where it cut for the saved world (a [6, 12] array: dimension 1
    over 4 ranks, 0 over 2), and an array it cannot cut is held whole, as
    ZeRO holds it."""
    whole = _whole_box(shape)
    if group is None or spec is None:
        return whole, None
    axes = set(group.axis_names)
    named = [(i, p) for i, p in enumerate(spec) if p is not None]
    if not named:
        return whole, None
    kept = [(i, p) for i, p in named if isinstance(p, str) and p in axes]
    if len(kept) != len(named) or len(kept) > 1:
        _ck._warn_reshard_fallback(path, spec, group, ValueError(
            f"axes {[p for _, p in named]} are not the group's only axis "
            f"{group.axis_names}"))
        return whole, None
    i, axis = kept[0]
    n, r = group.nranks, group.rank
    if axis == _zero.AXIS:
        i = _zero.shard_dim(shape, n)
        if i is None or n == 1:
            return whole, None
    elif shape[i] % n:
        _ck._warn_reshard_fallback(path, spec, group, ValueError(
            f"dimension {i} ({shape[i]}) does not divide by {n}"))
        return whole, None
    k = shape[i] // n
    whole[i] = [r * k, (r + 1) * k]
    return whole, tuple(axis if j == i else None for j in range(len(shape)))


def load_step(step_dir: str, mesh=None) -> Any:
    """Rebuild one step's tree for this rank. ``mesh``: the group to
    re-shard onto (module docstring); each array of a spec naming its axis
    comes back as this rank's ShardedTensor, the rest whole. Only the
    chunks that overlap what this rank needs are read and CRC-checked.
    Raises CheckpointCorruptError when a needed array cannot be rebuilt
    (missing, truncated or bit-flipped chunks, bad manifests), never a raw
    unpickling error."""
    from ..fault import site as _fault_site
    scan = scan_step(step_dir)
    if not scan.manifests:
        reason = "no committed manifests"
        if scan.tmp_manifests:
            reason += " (prepared-but-uncommitted tmps present: torn step)"
        if scan.bad_manifests:
            reason += f"; bad: {scan.bad_manifests[0][1]}"
        raise CheckpointCorruptError(step_dir, reason)
    base = next(iter(scan.manifests.values()))
    chunks_by_path: Dict[str, List[dict]] = {}
    for m in scan.manifests.values():
        for rec in m["chunks"]:
            chunks_by_path.setdefault(rec["path"], []).append(rec)
    _fault_site("ckpt.reshard")
    arrays: Dict[str, Any] = {}
    for path, meta in base["arrays"].items():
        shape = tuple(int(d) for d in meta["shape"])
        dtype = _np_dtype(meta["dtype"])
        spec = _spec_from_json(meta.get("spec"))
        need, kept = _target_box(path, shape, spec, mesh)
        buf = np.zeros(tuple(b - a for a, b in need), dtype=dtype)
        recs = chunks_by_path.get(path, [])
        covered = 0
        for rec in recs:
            if not _boxes_overlap(rec["index"], need):
                continue
            arr = _read_chunk(step_dir, rec, dtype)
            clip = [[max(a, c), min(b, d)]
                    for (a, b), (c, d) in zip(rec["index"], need)]
            buf[tuple(slice(a - c, b - c) for (a, b), (c, _) in
                      zip(clip, need))] = arr[tuple(
                          slice(a - c, b - c) for (a, b), (c, _) in
                          zip(clip, rec["index"]))]
            covered += _box_volume(clip)
        if covered < _box_volume(need):
            raise CheckpointCorruptError(
                step_dir, f"array {path!r}: chunks do not cover the "
                          f"needed region {need}")
        t = _to_tensor(buf, meta["dtype"])
        arrays[path] = (t if kept is None
                        else ShardedTensor(shape, need, t, kept))
    try:
        return _decode_tree(base["tree"], arrays)
    except CheckpointCorruptError:
        raise
    except Exception as e:
        raise CheckpointCorruptError(
            step_dir, f"manifest tree decode failed: "
                      f"{type(e).__name__}: {e}") from e


# ---------------------------------------------------------------------------
# background writer
# ---------------------------------------------------------------------------
class _AsyncWriter:
    """One background writer a manager, a queue of one: ``submit`` waits
    while the previous save is still being written (the step stalls only
    when it outruns the disk), then hands the job to a daemon thread.
    Failures are kept and raised by the next ``drain``/``submit``: a
    silently lost checkpoint is worse than a late crash."""

    def __init__(self):
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._job = None
        self._thread: Optional[threading.Thread] = None
        self._errors: List[BaseException] = []
        self._results: List[bool] = []

    def _loop(self):
        while True:
            with self._lock:
                while self._job is None:
                    self._idle.wait()
                job = self._job
            t0 = time.perf_counter()
            try:
                self._results.append(bool(job()))
            except BaseException as e:
                self._errors.append(e)
                self._results.append(False)
            finally:
                # the snapshot's host copies (the whole saved state) are
                # let go once written, not held until the next save
                job = None
                if _metrics_mod.enabled():
                    _M_ASYNC_SECONDS.observe(time.perf_counter() - t0)
                with self._lock:
                    self._job = None
                    if _metrics_mod.enabled():
                        _M_ASYNC_PENDING.set(0.0)
                    self._idle.notify_all()

    def submit(self, job):
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name="sharded-ckpt-writer")
                self._thread.start()
            while self._job is not None:  # one in flight
                self._idle.wait()
            self._job = job
            if _metrics_mod.enabled():
                _M_ASYNC_PENDING.set(1.0)
            self._idle.notify_all()
        self._raise_pending()

    def drain(self):
        """Wait for the save in flight, if any; raise the first background
        failure."""
        with self._lock:
            while self._job is not None:
                self._idle.wait()
        self._raise_pending()

    def busy(self) -> bool:
        with self._lock:
            return self._job is not None

    def take_results(self) -> List[bool]:
        out, self._results = self._results, []
        return out

    def _raise_pending(self):
        if self._errors:
            err = self._errors[0]
            self._errors.clear()
            raise err


# ---------------------------------------------------------------------------
# manager
# ---------------------------------------------------------------------------
def _step_dirs(dirname: str, prefix: str) -> List[Tuple[int, str]]:
    """[(step, path)] of ``<prefix>_<step>`` directories, newest first."""
    return [(s, p) for s, p in _ck._step_entries(dirname, prefix)
            if os.path.isdir(p)]


def newest_committed_step(dirname: str, prefix: str = "ckpt",
                          min_step: int = -1,
                          skip: Optional[set] = None
                          ) -> Optional[Tuple[int, str]]:
    """(step, path) of the newest step directory that verifies
    ``complete`` (shallow), skipping steps <= ``min_step`` and those in
    ``skip``; None when none does."""
    for step, path in _step_dirs(dirname, prefix):
        if step <= min_step:
            return None
        if skip and step in skip:
            continue
        if verify_step(path)[0] == "complete":
            return step, path
    return None


class ShardedCheckpointManager(CheckpointManager):
    """``CheckpointManager`` over the chunked layout (module docstring).

    One directory serves every rank (rank-named chunks and manifests; a
    commit renames this rank's manifest only). ``async_save`` takes the
    write off the step: a synchronous host snapshot, then the background
    writer, with the coordinated barrier on the writer thread after the
    write; ``save()`` then reports the previous round's outcome.
    ``load_latest`` agrees on the resume step over manifests (presence and
    length, never payloads) and restores onto ``mesh`` (a group), whatever
    world the step was written on. ``rank``/``world_size`` come from the
    coordinator when there is one, else from ``PADDLE_TRAINER_ID`` /
    ``PADDLE_TRAINERS_NUM``."""

    layout = "sharded"

    # the preemption handler must not start a nested coordinated save
    # while a save is queued or running on the writer
    @property
    def _save_in_flight(self) -> bool:
        return self._sif_flag or (self.async_save and self._writer.busy())

    @_save_in_flight.setter
    def _save_in_flight(self, value: bool):
        self._sif_flag = bool(value)

    def __init__(self, dirname: str, prefix: str = "ckpt",
                 keep_last_n: int = 5, async_save: bool = False,
                 mesh=None, coordinator=None, store=None, rank: int = 0,
                 world_size: int = 1, barrier_timeout: Optional[float] = None):
        self._writer = _AsyncWriter()  # before super(): _save_in_flight
        self._sif_flag = False
        super().__init__(dirname, prefix=prefix, keep_last_n=keep_last_n,
                         async_save=async_save, mesh=mesh,
                         coordinator=coordinator, store=store, rank=rank,
                         world_size=world_size,
                         barrier_timeout=barrier_timeout)
        if self.coordinator is not None:
            self._rank = self.coordinator.rank
            self._world = self.coordinator.world_size
        else:
            env_rank = os.environ.get("PADDLE_TRAINER_ID")
            env_world = os.environ.get("PADDLE_TRAINERS_NUM")
            try:
                self._rank = int(env_rank) if rank == 0 and env_rank \
                    else int(rank)
                self._world = int(env_world) \
                    if world_size == 1 and env_world else int(world_size)
            except ValueError:
                # files are named by rank: a silent rank-0 fallback would
                # have every host of a shared directory clobber rank 0's
                raise ValueError(
                    f"PADDLE_TRAINER_ID={env_rank!r} / "
                    f"PADDLE_TRAINERS_NUM={env_world!r} must be integers: "
                    f"the sharded checkpoint layout names its files by "
                    f"rank, and a silent rank-0 fallback would collide "
                    f"every host's chunks in a shared directory")
        self._attempt = 0
        self._resume_cache = None
        self._sweep_orphans()

    # -- save ----------------------------------------------------------------
    def save(self, state: Any, step: int) -> bool:
        """Publish one step. The host snapshot is synchronous; with
        ``async_save`` the write and commit run on the writer (and the
        previous async round's outcome is returned), otherwise here.
        False when a coordinated round aborted."""
        self._attempt += 1
        attempt = self._attempt
        prev = self._last_step
        if prev is not None and prev != int(step):
            # the post-commit mirror may have raced the peer's rename
            self._mirror_peer_manifest(self.path_for(prev))
        snap = snapshot_tree(state)
        if self.async_save:
            if self.coordinator is not None:
                self._save_in_flight = True
            self._writer.submit(lambda: self._publish(snap, step, attempt))
            committed = all(self._writer.take_results())
        else:
            committed = self._publish(snap, step, attempt)
        self._last_step = int(step)
        self.gc()
        return committed

    def _publish(self, snap: _Snapshot, step: int, attempt: int) -> bool:
        """Write this rank's chunks and commit: through the two-phase
        barrier when coordinated, a plain rename otherwise."""
        step_dir = self.path_for(step)
        final = os.path.join(step_dir, _manifest_name(self._rank))
        tmp = None
        try:
            if self.coordinator is not None:
                self._save_in_flight = True
            t0 = time.perf_counter()
            try:
                tmp, nbytes = write_shards(step_dir, step, self._rank,
                                           self._world, snap,
                                           attempt=attempt)
            except BaseException:
                if self.coordinator is not None:
                    # poison and consume the round: peers abort at once
                    self.coordinator.abort_next_round(step)
                self._gc_attempt(step_dir, attempt)
                raise
            write_secs = time.perf_counter() - t0
            if _metrics_mod.enabled():
                _M_ASYNC_BYTES.inc(nbytes)
            if self.coordinator is not None:
                try:
                    committed = self.coordinator.commit(
                        step, lambda: os.replace(tmp, final))
                except BaseException:
                    self._gc_attempt(step_dir, attempt)
                    raise
                if not committed:
                    self._gc_attempt(step_dir, attempt)
                    warnings.warn(
                        f"coordinated sharded checkpoint step {int(step)} "
                        f"aborted — not every host prepared in time; no "
                        f"host committed its manifest for this step")
                    return False
            else:
                os.replace(tmp, final)
            if _metrics_mod.enabled():
                _ck._M_SAVES.inc()
                _ck._M_SAVE_SECONDS.observe(write_secs)
            self._mirror_peer_manifest(step_dir)
            return True
        finally:
            if self.coordinator is not None:
                self._save_in_flight = False

    def _mirror_peer_manifest(self, step_dir: str):
        """Copy peer ``(rank+1)%world``'s committed manifest to its
        ``.mirror`` name (tmp and rename, best effort). A world of one has
        no peer."""
        if self._world <= 1:
            return
        peer = (self._rank + 1) % self._world
        src = os.path.join(step_dir, _manifest_name(peer))
        dst = os.path.join(step_dir, _mirror_name(peer))
        tmp = dst + f".tmp.r{self._rank}"
        try:
            deadline = time.monotonic() + 0.5
            while True:
                try:
                    with open(src, "rb") as f:
                        data = f.read()
                    break
                except FileNotFoundError:
                    if time.monotonic() >= deadline:
                        return
                    time.sleep(0.01)
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, dst)
        except OSError:
            self._rm_quiet(tmp)

    def _gc_attempt(self, step_dir: str, attempt: int):
        """Drop this rank's files of one failed or aborted attempt."""
        marker, own = f"a{int(attempt)}.", f"r{self._rank}-"
        try:
            names = os.listdir(step_dir)
        except OSError:
            return
        for fn in names:
            if (fn.startswith(own) and marker in fn) or \
                    fn == _manifest_name(self._rank) + ".tmp.prep":
                self._rm_quiet(os.path.join(step_dir, fn))
        try:  # a failed first attempt may leave an empty step directory
            os.rmdir(step_dir)
        except OSError:
            pass

    def _publish_sync(self, state: Any, step: int) -> bool:
        """The preemption save: let the save in flight finish (it holds a
        barrier round), then publish synchronously."""
        try:
            self._writer.drain()
        except BaseException as e:
            warnings.warn(f"pending background checkpoint save failed "
                          f"during preemption drain: {e}")
        self._attempt += 1
        return self._publish(snapshot_tree(state), step, self._attempt)

    # -- read ----------------------------------------------------------------
    def drain(self):
        self._writer.drain()
        _ck.wait_all()

    def steps(self) -> List[int]:
        return [s for s, _ in _step_dirs(self.dirname, self.prefix)]

    def _local_restorable_step(self) -> Optional[int]:
        """The newest step a restore could use, judged from manifests
        (under valid-only resume each candidate is loaded and its weights
        checked finite, and the state kept for the restore)."""
        self._resume_cache = None
        valid_only = _ck.resume_valid_only()
        for step, path in _step_dirs(self.dirname, self.prefix):
            if verify_step(path)[0] not in ("complete", "partial"):
                continue
            if valid_only:
                try:
                    state = load_step(path, mesh=self.mesh)
                except (OSError, CheckpointCorruptError):
                    continue
                if not _ck.tree_finite(state):
                    _ck._note_nonfinite_skip(path)
                    continue
                self._resume_cache = (step, state)
            return step
        return None

    def latest_valid_path(self) -> Optional[str]:
        self._writer.drain()
        step = self._local_restorable_step()
        self._resume_cache = None
        return None if step is None else self.path_for(step)

    def load_latest(self) -> Optional[Tuple[Any, int]]:
        """(state, step) of the newest restorable step, or None. With a
        coordinator the ranks agree on the step over manifests first, and
        a agreed step that then fails its CRCs raises (peers restore it);
        without one a corrupt step warns and the next-newest is tried."""
        self._writer.drain()
        _ck.wait_all()
        valid_only = _ck.resume_valid_only()
        if self.coordinator is not None:
            agreed = self.coordinator.negotiate_resume(
                self._local_restorable_step())
            cache, self._resume_cache = self._resume_cache, None
            if agreed is None:
                return None
            if cache is not None and cache[0] == int(agreed):
                state = cache[1]
            else:
                cache = None
                state = load_step(self.path_for(agreed), mesh=self.mesh)
                if valid_only and not _ck.tree_finite(state):
                    if _metrics_mod.enabled():
                        _ck._M_SKIP_NONFINITE.inc()
                    raise CheckpointCorruptError(
                        self.path_for(agreed),
                        f"fleet-agreed resume step {agreed} holds "
                        f"nonfinite weights under valid-only resume")
            if _metrics_mod.enabled():
                _ck._M_LOADS.inc()
            return state, int(agreed)
        for step, path in _step_dirs(self.dirname, self.prefix):
            status, detail = verify_step(path)
            if status not in ("complete", "partial"):
                if status == "corrupt":
                    warnings.warn(f"skipping corrupt sharded checkpoint "
                                  f"{path}: {detail}")
                    if _metrics_mod.enabled():
                        _ck._M_CORRUPT.inc()
                continue
            try:
                state = load_step(path, mesh=self.mesh)
            except (OSError, CheckpointCorruptError) as e:
                warnings.warn(f"skipping corrupt sharded checkpoint "
                              f"{path}: {e}")
                if _metrics_mod.enabled():
                    _ck._M_CORRUPT.inc()
                continue
            if valid_only and not _ck.tree_finite(state):
                _ck._note_nonfinite_skip(path)
                continue
            if _metrics_mod.enabled():
                _ck._M_LOADS.inc()
            return state, step
        return None

    # -- gc ------------------------------------------------------------------
    def gc(self) -> int:
        """Keep the newest ``keep_last_n`` step directories (every rank
        removes the rest; the races are benign) and sweep this rank's
        orphans while no background save is in flight."""
        removed = 0
        for step, path in _step_dirs(self.dirname, self.prefix)[
                self.keep_last_n:]:
            shutil.rmtree(path, ignore_errors=True)
            if not os.path.isdir(path):
                removed += 1
                if _metrics_mod.enabled():
                    _ck._M_GC.inc()
        if not self._writer.busy():
            removed += self._sweep_orphans()
        return removed

    def _sweep_orphans(self) -> int:
        """Remove this rank's leftovers of crashed or aborted attempts (its
        tmp manifests, its torn mirror writes, its chunks its committed
        manifest does not name). A peer's files are never touched: in a
        shared directory its tmp may be a live prepare."""
        removed = 0
        for _step, step_dir in _step_dirs(self.dirname, self.prefix):
            try:
                names = os.listdir(step_dir)
            except OSError:
                continue
            referenced = set()
            mine = _manifest_name(self._rank)
            if mine in names:
                try:
                    with open(os.path.join(step_dir, mine), "rb") as f:
                        m = json.loads(f.read().decode())
                    referenced = {rec["file"] for rec in m.get("chunks", [])}
                except (OSError, ValueError, KeyError):
                    referenced = None  # unreadable: keep everything
            own = f"r{self._rank}-"
            for fn in names:
                path = os.path.join(step_dir, fn)
                if fn == mine + ".tmp.prep" or \
                        fn.endswith(_MIRROR_SUFFIX + f".tmp.r{self._rank}"):
                    self._rm_quiet(path)
                    removed += 1
                elif referenced is not None and fn.startswith(own) \
                        and fn.endswith(".chunk") and fn not in referenced:
                    self._rm_quiet(path)
                    removed += 1
        if removed and _metrics_mod.enabled():
            _ck._M_GC.inc(removed)
        return removed


__all__ = ["ShardedCheckpointManager", "snapshot_tree", "write_shards",
           "scan_step", "verify_step", "load_step", "owner_rank",
           "is_step_dir", "newest_committed_step", "MANIFEST_MAGIC"]
