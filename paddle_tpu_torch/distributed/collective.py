"""Collective communication API (counterpart of
``paddle_tpu/distributed/collective.py``).

The reference is single-controller: one process drives every device of
a mesh, a group is a named-axis view of it, and an eager collective
runs as a one-shot ``shard_map`` in which shard r plays rank r. The port
has one process per rank over ``torch.distributed``, and a group is a
torch process group. The two meet in one rule: **rank r of the port is
device r of the reference's group**, so what the port's rank r holds
before and after a call equals shard r of the reference's tensor. A
replicated tensor is the same value on every rank, so ``all_reduce`` of
one sums N equal copies in both packages.

Backends: ``nccl`` when the rank's device is a card (one card a rank),
``gloo`` when ``PADDLE_DISTRI_BACKEND=gloo`` or the caller asks for the
CPU. Under gloo, a card's tensors go only through ``all_reduce`` and
``broadcast`` (what torch's gloo backend takes on CUDA); every other
collective raises on them, naming the backend, and nothing is staged
quietly through host memory.

Every launch through this module counts in ``launch_stats()`` (by kind;
``recorded``/``add_counts`` carry the counts of a CUDA graph's capture
into its replays), and an eager call is metered and bounded like the
reference's: ``collective_calls_total``/``collective_bytes_total``, the
``collective_seconds`` histogram (the step diagnosis's "collective"
term), and with ``PADDLE_TPU_COLLECTIVE_TIMEOUT`` set a deadline past
which the call raises ``CollectiveTimeoutError`` (fault site
``collective.timeout``).
"""
from __future__ import annotations

import contextlib
import datetime
import threading
import time
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..profiler import events as _events_mod
from ..profiler import metrics as _metrics_mod
from .env import ParallelEnv

_REG = _metrics_mod.default_registry()
_M_COLL_CALLS = _REG.counter(
    "collective_calls_total",
    "eager collective launches by kind and link class (the backend)")
_M_COLL_BYTES = _REG.counter(
    "collective_bytes_total",
    "bytes handed to eager collectives on this rank, by kind and link "
    "class (the backend)")
_M_COLL_TIMEOUT = _REG.counter(
    "collective_timeout_total",
    "eager collectives that exceeded the deadline (or hit the armed "
    "collective.timeout fault site), by kind and group")
_M_COLL_SECONDS = _REG.histogram(
    "collective_seconds",
    "eager collective wall time (launch through completion) by kind — the "
    "step-diagnosis 'collective' signal; a collective captured into a "
    "CUDA graph runs on the device's clock and is not timed here")

_TP = "ROADMAP A11 (tensor-parallel layers with fleet)"


class CollectiveTimeoutError(RuntimeError):
    """An eager collective exceeded its deadline instead of completing.

    Raised (instead of hanging) when ``PADDLE_TPU_COLLECTIVE_TIMEOUT`` is
    set and the launch+completion of an eager collective outlives it — the
    classic symptom of a peer that died mid-rendezvous — or when the
    ``collective.timeout`` fault site is armed. Names the group and this
    process's rank. Recovery: restart the process; the abandoned watchdog
    thread cannot be cancelled and its collective may still complete."""

    def __init__(self, kind: str, group: "Group", rank: int,
                 timeout: float, detail: str = ""):
        msg = (f"collective {kind!r} over group {group.name!r} "
               f"(axes {group.axis_names}, {group.nranks} ranks) "
               f"did not complete within {timeout:g}s on process rank {rank}")
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)
        self.kind = kind
        self.group_name = group.name
        self.rank = rank
        self.timeout = timeout


class ReduceOp:
    """Reduction kinds (the reference's ``ReduceOp``)."""
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT}


# ---------------------------------------------------------------------------
# launch counts (carried through CUDA graphs like the kernels' counters)
# ---------------------------------------------------------------------------
_launches: dict = {}


def _count(kind: str) -> None:
    _launches[kind] = _launches.get(kind, 0) + 1


def launch_stats() -> dict:
    """{kind: collectives launched} since the last
    :func:`reset_launch_stats` (a replayed graph's count its capture's)."""
    return dict(_launches)


def reset_launch_stats() -> None:
    _launches.clear()


@contextlib.contextmanager
def recorded():
    """Count the block's collectives apart (a CUDA graph's capture):
    afterwards the counts are as before it, and the yielded dict holds
    what :func:`add_counts` adds once per replay."""
    before = dict(_launches)
    rec: dict = {}
    try:
        yield rec
    finally:
        for k, n in _launches.items():
            if n != before.get(k, 0):
                rec[k] = n - before.get(k, 0)
        _launches.clear()
        _launches.update(before)


def add_counts(rec: dict) -> None:
    for k, n in rec.items():
        _launches[k] = _launches.get(k, 0) + n


# ---------------------------------------------------------------------------
# groups
# ---------------------------------------------------------------------------
class Group:
    """A communication group: a torch process group over some ranks of a
    rank grid (``topology.build_mesh``), on named axes.

    ``ranks`` are global ranks in group order; ``rank`` is this process's
    place in them (-1 when it is not a member), ``nranks`` their count. A
    group built before ``init_parallel_env`` (a topology computed from the
    env contract alone) has no process group: its collectives raise."""

    _next_id = 0

    def __init__(self, mesh=None, axis_names: Sequence[str] = ("world",),
                 ranks: Optional[List[int]] = None, name: str = "", *,
                 pg=None, backend: Optional[str] = None):
        self.mesh = mesh
        self.axis_names = tuple(axis_names)
        if ranks is None:
            me = _proc_rank()
            ranks = (mesh.axis_ranks(self.axis_names, me)
                     if mesh is not None else list(range(_world_size())))
        self.ranks = [int(r) for r in ranks]
        self.nranks = len(self.ranks)
        self.pg = pg
        self.backend = backend or (_default_group.backend
                                   if _default_group is not None else None)
        self.name = name or "_".join(self.axis_names)
        self.id = Group._next_id
        Group._next_id += 1

    @property
    def axis(self) -> Union[str, Tuple[str, ...]]:
        return self.axis_names[0] if len(self.axis_names) == 1 \
            else self.axis_names

    @property
    def world_size(self) -> int:
        return self.nranks

    @property
    def rank(self) -> int:
        return self.get_group_rank(_proc_rank())

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank) if rank in self.ranks else -1

    def process_group(self):
        return self.pg

    def __repr__(self):
        return (f"Group(id={self.id}, axes={self.axis_names}, "
                f"ranks={self.ranks}, backend={self.backend})")


_default_group: Optional[Group] = None
_groups_by_id: dict = {}


def _proc_rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return ParallelEnv().rank


def _world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return ParallelEnv().world_size


def _set_default_group(group: Optional[Group]) -> None:
    global _default_group
    _default_group = group
    if group is not None:
        _groups_by_id[group.id] = group


def _get_default_group() -> Group:
    if _default_group is None:
        from .parallel import init_parallel_env
        init_parallel_env()
    return _default_group


def _resolve(group) -> Group:
    if group is None:
        return _get_default_group()
    if isinstance(group, Group):
        return group
    if isinstance(group, int):
        return _groups_by_id[group]
    raise TypeError(f"not a group: {group!r}")


def get_group(gid: int = 0) -> Group:
    return _groups_by_id.get(gid) or _get_default_group()


def _timeout(timeout) -> Optional[datetime.timedelta]:
    if timeout is None or isinstance(timeout, datetime.timedelta):
        return timeout
    return datetime.timedelta(seconds=float(timeout))


def _make_groups(rank_lists: Sequence[Sequence[int]], axis_names,
                 mesh=None, backend=None, timeout=None, name: str = ""
                 ) -> Optional[Group]:
    """Create one process group per list (every process takes part in
    every creation, in the same order, as torch requires) and return the
    Group of the list that holds this process (None if none does). Before
    ``init_parallel_env`` the Groups carry no process group."""
    me = _proc_rank()
    live = dist.is_available() and dist.is_initialized()
    world = _get_default_group() if live else None
    backend = backend or (world.backend if world is not None else None)
    mine = None
    for ranks in rank_lists:
        ranks = [int(r) for r in ranks]
        pg = None
        if live:
            if world is not None and ranks == world.ranks:
                pg = world.pg
            else:
                kw = {"backend": backend}
                if timeout is not None:
                    kw["timeout"] = _timeout(timeout)
                pg = dist.new_group(ranks=ranks, **kw)
        if me in ranks:
            mine = Group(mesh, axis_names, ranks=ranks, name=name, pg=pg,
                         backend=backend)
            _groups_by_id[mine.id] = mine
    return mine


def new_group(ranks=None, backend=None, timeout=None,
              axis_name: Optional[str] = None) -> Group:
    """A group over ``ranks`` (global ranks; every process of the world
    calls this, members or not, as in the reference's NCCL world), or
    over the mesh axis ``axis_name`` of the hybrid topology (every axis
    slice gets its group; this process's is returned), or over the whole
    world. ``backend`` defaults to the world's."""
    if axis_name is not None:
        from .topology import canon_axis, get_hybrid_communicate_group
        hcg = get_hybrid_communicate_group()
        if hcg is not None:
            return hcg._axis_group(axis_name)
        from .topology import build_mesh
        mesh = build_mesh({canon_axis(axis_name): _world_size()})
        return _make_groups(mesh.comm_lists((canon_axis(axis_name),)),
                            (canon_axis(axis_name),), mesh, backend,
                            timeout)
    if ranks is None:
        ranks = list(range(_world_size()))
    g = _make_groups([list(ranks)], ("world",), None, backend, timeout)
    if g is None:  # not a member: a descriptor only, as torch returns
        g = Group(None, ("world",), ranks=list(ranks), backend=backend)
        _groups_by_id[g.id] = g
    return g


def is_initialized() -> bool:
    return _default_group is not None


def destroy_process_group(group=None):
    """Tear down ``group``'s process group, or with no argument every
    group and the world (``init_parallel_env`` may then run again; the
    world's teardown first waits for every rank, so rank 0, which hosts
    the rendezvous store, outlives the peers' use of it)."""
    global _default_group
    if group is not None:
        g = _resolve(group)
        if g.pg is not None and g is not _default_group and \
                dist.is_initialized():
            dist.destroy_process_group(g.pg)
        _groups_by_id.pop(g.id, None)
        return
    from . import parallel, topology
    topology.set_hybrid_communicate_group(None)
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() > 1:
            # rank 0 hosts the rendezvous store that peers may still be
            # reading (a checkpoint coordinator's last poll): the world
            # ends only when every rank has reached its end
            try:
                dist.barrier()
            except Exception:
                pass  # a peer is gone: nothing left to wait for
        dist.destroy_process_group()
    _default_group = None
    _groups_by_id.clear()
    parallel._reset()


# ---------------------------------------------------------------------------
# the deadline guard and accounting
# ---------------------------------------------------------------------------
def _deadline_seconds() -> float:
    """0 = guard disabled (the default). Set
    ``PADDLE_TPU_COLLECTIVE_TIMEOUT`` (seconds) to bound every eager
    collective: launch and completion run on a watchdog thread, and a
    blown deadline raises CollectiveTimeoutError instead of hanging. Size
    it to cover the first call of a group too (the communicator's
    set-up)."""
    from ..utils.envparse import env_float
    return env_float("PADDLE_TPU_COLLECTIVE_TIMEOUT", 0.0)


def _timed_out(kind: str, group: Group):
    if _metrics_mod.enabled():
        _M_COLL_TIMEOUT.inc(kind=kind, group=group.name)
    _events_mod.emit("collective_timeout", severity="error",
                     collective=kind, group=group.name, rank=_proc_rank())


def _complete() -> None:
    """Wait until the device work a collective queued is done."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _GuardWorker:
    """A long-lived watchdog thread serving guarded eager collectives. A
    ``None`` job is the exit sentinel."""

    def __init__(self):
        import queue
        self.jobs: "queue.SimpleQueue" = queue.SimpleQueue()
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="collective-guard-worker")
        self.thread.start()

    def _loop(self):
        while True:
            job = self.jobs.get()
            if job is None:
                return
            thunk, box, done = job
            try:
                r = thunk()
                _complete()  # the deadline covers completion too
                box["v"] = r
            except BaseException as e:
                box["e"] = e
            done.set()


_guard_worker: Optional[_GuardWorker] = None
_guard_worker_lock = threading.Lock()
_guard_worker_spawns = 0  # regression-test hook: reuse keeps this flat


def _run_on_guard_worker(thunk, timeout: float):
    """Run ``thunk`` on the pooled watchdog worker (checked out for the
    job), bounded by ``timeout``. Returns the result box, or None on the
    deadline, when the worker is abandoned (it may be wedged in the hung
    collective)."""
    global _guard_worker, _guard_worker_spawns
    with _guard_worker_lock:
        w = _guard_worker
        _guard_worker = None
        if w is None or not w.thread.is_alive():
            w = _GuardWorker()
            _guard_worker_spawns += 1
    box: dict = {}
    done = threading.Event()
    w.jobs.put((thunk, box, done))
    if not done.wait(timeout):
        return None
    with _guard_worker_lock:
        if _guard_worker is None:
            _guard_worker = w
        else:
            w.jobs.put(None)
    return box


def _guard_collective(kind: str, group: Group, thunk):
    """Run one eager collective under the timeout contract, timed into
    ``collective_seconds``."""
    from ..fault import InjectedFault, InjectedIOError, site as _fault_site
    try:
        _fault_site("collective.timeout")
    except (TimeoutError, InjectedFault, InjectedIOError) as e:
        # every injected kind here models a hung collective
        _timed_out(kind, group)
        raise CollectiveTimeoutError(kind, group, _proc_rank(), 0.0,
                                     detail="injected fault") from e
    _count(kind)
    timeout = _deadline_seconds()
    if timeout <= 0:
        if not _metrics_mod.enabled():
            return thunk()
        t0 = time.perf_counter()
        try:
            return thunk()
        finally:
            _M_COLL_SECONDS.observe(time.perf_counter() - t0, kind=kind)
    t0 = time.perf_counter()
    box = _run_on_guard_worker(thunk, timeout)
    if box is not None and _metrics_mod.enabled():
        _M_COLL_SECONDS.observe(time.perf_counter() - t0, kind=kind)
    if box is None:
        _timed_out(kind, group)
        raise CollectiveTimeoutError(kind, group, _proc_rank(), timeout)
    if "e" in box:
        raise box["e"]
    return box["v"]


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return 0


def _account(kind: str, group: Group, *tensors):
    """Count one eager collective into the metrics registry."""
    if not _metrics_mod.enabled():
        return
    link = group.backend or "none"
    _M_COLL_CALLS.inc(kind=kind, link=link)
    _M_COLL_BYTES.inc(sum(_nbytes(t) for t in tensors), kind=kind,
                      link=link)


_GLOO_CUDA = ("all_reduce", "broadcast")


def _prepare(kind: str, group, *tensors) -> Group:
    """Resolve the group and hold the call to what its backend takes."""
    g = _resolve(group)
    if g.pg is None:
        raise RuntimeError(
            f"{kind} over group {g.name!r} (ranks {g.ranks}): no process "
            f"group" + (" on this rank, which is not a member" if
                        dist.is_initialized() else
                        "; call init_parallel_env() first"))
    cuda = any(t.is_cuda for t in _flat(tensors))
    if cuda and g.backend == "gloo" and kind not in _GLOO_CUDA:
        raise RuntimeError(
            f"{kind} over group {g.name!r}: the gloo backend takes a "
            f"card's tensors only in {' and '.join(_GLOO_CUDA)}; use nccl "
            f"(one card a rank) or CPU tensors")
    return g


def _flat(tensors):
    for t in tensors:
        if isinstance(t, torch.Tensor):
            yield t
        elif isinstance(t, (list, tuple)):
            yield from _flat(t)


def _run(kind: str, g: Group, thunk, *tensors):
    _account(kind, g, *tensors)
    return _guard_collective(kind, g, thunk)


def _global(g: Group, group_rank: int) -> int:
    return g.ranks[group_rank]


def raw_all_reduce(t: torch.Tensor, g: Group, op=ReduceOp.SUM,
                   kind: str = "all_reduce") -> None:
    """In place, unguarded and untimed: the form a CUDA graph may hold
    (the grouped TrainStep's buckets, the grouped cross-entropy, the
    group's batch-norm statistics). Counted in ``launch_stats()`` under
    ``kind`` (the batch norms' under "bn_sync", apart from the
    gradients')."""
    _count(kind)
    dist.all_reduce(t, op=_TORCH_OP[op], group=g.pg)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=False):
    """In-place all-reduce; returns the tensor. This rank's value plays
    the reference's shard of this rank: a sharded reference tensor
    reduces rank for rank, a replicated one (the same value on every
    rank) sums N copies."""
    g = _prepare("all_reduce", group, tensor)

    def thunk():
        if op == ReduceOp.AVG:
            if g.backend == "nccl":
                dist.all_reduce(tensor, op=dist.ReduceOp.AVG, group=g.pg)
            else:
                dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=g.pg)
                tensor.div_(g.nranks)
        else:
            dist.all_reduce(tensor, op=_TORCH_OP[op], group=g.pg)
        return tensor

    return _run("all_reduce", g, thunk, tensor)


def all_gather(tensor_list, tensor=None, group=None, sync_op=True, axis=0):
    """``all_gather(tensor_list, tensor)`` appends every rank's tensor to
    the list; ``all_gather(None, x)`` (or ``all_gather(x)``) returns them
    stacked on a new leading axis (``axis`` 0) or concatenated along
    ``axis``, as the reference does."""
    if tensor is None and not isinstance(tensor_list, list):
        tensor_list, tensor = None, tensor_list
    g = _prepare("all_gather", group, tensor)

    def thunk():
        outs = [torch.empty_like(tensor) for _ in range(g.nranks)]
        dist.all_gather(outs, tensor.contiguous(), group=g.pg)
        return outs

    outs = _run("all_gather", g, thunk, tensor)
    if isinstance(tensor_list, list):
        tensor_list.extend(outs)
        return tensor_list
    return torch.stack(outs, 0) if axis == 0 else torch.cat(outs, dim=axis)


def all_gather_object(object_list, obj, group=None):
    """Appends every rank's ``obj`` to ``object_list`` (the reference's
    single controller appends N copies of its one object)."""
    g = _prepare("all_gather_object", group)

    def thunk():
        out = [None] * g.nranks
        dist.all_gather_object(out, obj, group=g.pg)
        return out

    object_list.extend(_run("all_gather_object", g, thunk))
    return object_list


def broadcast(tensor, src=0, group=None, sync_op=True):
    """Broadcast from group rank ``src`` into ``tensor`` in place."""
    g = _prepare("broadcast", group, tensor)

    def thunk():
        dist.broadcast(tensor, src=_global(g, src), group=g.pg)
        return tensor

    return _run("broadcast", g, thunk, tensor)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Every rank keeps the reduced value, ``dst`` included: the
    reference's superset of paddle's reduce, kept so that a call means
    the same in both packages."""
    return all_reduce(tensor, op=op, group=group)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Group rank r receives ``tensor_list[r]`` of rank ``src`` into
    ``tensor``. Other ranks may pass None for the list."""
    g = _prepare("scatter", group, tensor, tensor_list or [])
    if tensor_list is None and g.rank == src:
        raise ValueError("scatter requires tensor_list on the source rank")

    def thunk():
        parts = ([t.contiguous() for t in tensor_list]
                 if g.rank == src else None)
        dist.scatter(tensor, parts, src=_global(g, src), group=g.pg)
        return tensor

    return _run("scatter", g, thunk, tensor)


def _set_result(tensor, out):
    if tuple(tensor.shape) == tuple(out.shape):
        tensor.copy_(out)
    else:  # the reference rebinds the Tensor's data
        tensor.data = out
    return tensor


def reduce_scatter(tensor, tensor_or_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Reduce the input (a list is concatenated along dim 0) over the
    group and leave chunk r of dim 0 on group rank r, in ``tensor``."""
    g = _prepare("reduce_scatter", group, tensor, tensor_or_list)
    x = (torch.cat(list(tensor_or_list), 0)
         if isinstance(tensor_or_list, (list, tuple)) else tensor_or_list)
    if x.shape[0] % g.nranks:
        raise ValueError(f"reduce_scatter: dim 0 ({x.shape[0]}) is not a "
                         f"multiple of the group's {g.nranks} ranks")

    def thunk():
        chunks = [c.contiguous() for c in x.chunk(g.nranks, 0)]
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, op=_TORCH_OP[op], group=g.pg)
        return out

    return _set_result(tensor, _run("reduce_scatter", g, thunk, x))


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    """Chunk i of the input (its leading axis, of length nranks, or the
    list's i-th tensor) goes to group rank i; the output's chunk j came
    from rank j."""
    g = _prepare("alltoall", group, in_tensor_list)
    ins = (list(in_tensor_list) if isinstance(in_tensor_list, (list, tuple))
           else list(in_tensor_list.unbind(0)))
    if len(ins) != g.nranks:
        raise ValueError(f"alltoall: {len(ins)} chunks for "
                         f"{g.nranks} ranks")

    def thunk():
        outs = [torch.empty_like(t) for t in ins]
        dist.all_to_all(outs, [t.contiguous() for t in ins], group=g.pg)
        return outs

    outs = _run("alltoall", g, thunk, ins)
    if isinstance(out_tensor_list, list):
        out_tensor_list.extend(outs)
        return out_tensor_list
    return torch.stack(outs, 0)


alltoall_single = alltoall


def send(tensor, dst=0, group=None, sync_op=True):
    """Send ``tensor`` to group rank ``dst`` (the reference has no
    point-to-point calls: its ``ppermute`` is the same exchange)."""
    g = _prepare("send", group, tensor)
    return _run("send", g, lambda: dist.send(
        tensor.contiguous(), _global(g, dst), group=g.pg), tensor)


def recv(tensor, src=0, group=None, sync_op=True):
    """Receive into ``tensor`` from group rank ``src``."""
    g = _prepare("recv", group, tensor)
    _run("recv", g, lambda: dist.recv(tensor, _global(g, src), group=g.pg),
         tensor)
    return tensor


def isend(tensor, dst=0, group=None):
    g = _prepare("send", group, tensor)
    _account("send", g, tensor)
    _count("send")
    return dist.isend(tensor.contiguous(), _global(g, dst), group=g.pg)


def irecv(tensor, src=0, group=None):
    g = _prepare("recv", group, tensor)
    _account("recv", g, tensor)
    _count("recv")
    return dist.irecv(tensor, _global(g, src), group=g.pg)


def ppermute(x, group=None, perm=None):
    """Collective permute: group rank s sends ``x`` to d for each (s, d)
    of ``perm`` (a ring shift by +1 by default); a rank that receives
    nothing gets zeros, as ``lax.ppermute`` gives. One batch of isend /
    irecv pairs (``batch_isend_irecv``)."""
    g = _prepare("ppermute", group, x)
    n = g.nranks
    if perm is None:
        perm = [(i, (i + 1) % n) for i in range(n)]
    me = g.rank

    def thunk():
        out = torch.zeros_like(x)
        ops = []
        src = x.contiguous()
        for s, d in perm:
            if s == me and d == me:
                out.copy_(x)
            elif s == me:
                ops.append(dist.P2POp(dist.isend, src, _global(g, d),
                                      group=g.pg))
            elif d == me:
                ops.append(dist.P2POp(dist.irecv, out, _global(g, s),
                                      group=g.pg))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return out

    return _run("ppermute", g, thunk, x)


def barrier(group=None):
    g = _prepare("barrier", group)

    def thunk():
        if g.backend == "nccl":
            dist.barrier(group=g.pg,
                         device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group=g.pg)

    _run("barrier", g, thunk)


def wait(tensor, group=None, use_calc_stream=True):
    """Wait for the device work queued on ``tensor``; returns it."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


def stream_synchronize():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def axis_rank(group=None) -> int:
    """This process's rank in ``group`` (the reference's in-trace
    ``lax.axis_index``)."""
    return _resolve(group).rank


def get_world_size_in_group(group=None) -> int:
    return _resolve(group).nranks


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """Megatron's sharded linear/embedding helper: not ported yet."""
    raise NotImplementedError(
        f"paddle.distributed.split builds tensor-parallel layers, which "
        f"wait for {_TP}")

