"""Parallel environment bootstrap and data parallelism (counterpart of
``paddle_tpu/distributed/parallel.py``).

The reference is one controller over a mesh: ``init_parallel_env``
joins the JAX coordinator, parameters are replicated over the ``dp``
axis, ``shard_batch`` places the global batch across it, and XLA puts
the gradient all-reduce inside the compiled backward. The port runs one
process per rank:

* ``init_parallel_env`` rendezvouses every rank on one ``TCPStore``
  (hosted by rank 0 on the first ``PADDLE_TRAINER_ENDPOINTS`` entry, or
  ``MASTER_ADDR``/``MASTER_PORT``) and brings up the torch process group:
  ``nccl`` with one card a rank, ``gloo`` under
  ``PADDLE_DISTRI_BACKEND=gloo`` or when the caller asks for the CPU;
* ``shard_batch(t)`` takes the global host batch and returns this rank's
  rows — the rows the reference places on device r — and
  ``replicate(t)`` broadcasts from rank 0, so one script drives either
  package;
* ``DataParallel`` broadcasts the parameters from rank 0 when it wraps a
  layer, and on the eager path (``loss.backward(); opt.step()``) the
  gradients arrive averaged over the group, through the port's own
  hook-driven bucketed reducer (``_Reducer``). ``jit.TrainStep`` over a
  ``DataParallel`` reduces its gradients inside its step instead (inside
  the captured graph on a card).

The global-batch loss. The reference's ``F.cross_entropy`` takes one mean
over the global batch; with ``ignore_index`` labels spread unevenly over
the ranks the mean of per-rank means is not that mean. So while a
``DataParallel`` is in use (from its forward) or a grouped ``TrainStep``
step runs, ``F.cross_entropy`` with ``reduction="mean"`` divides by the
label count all-reduced over the group (and ``"sum"`` scales to the
group's sum): the gradients the group averages are then the reference's,
and the loss value each rank gets is the reference's global loss.

The global-batch batch norm. The reference's batch statistics over a
dp-sharded batch are the global batch's (its mean runs over the sharded
array), and ``SyncBatchNorm`` is an alias there. So while a
``DataParallel``'s forward or a grouped ``TrainStep``'s step runs
(``bn_scope``, whose stack ``ops/_bn_common`` keeps), every
training-mode batch norm of the port takes the group's statistics: its
per-channel moments all-reduced with the row count between the kernel
launches, and in its backward the column sums that form dx (the Function
keeps the group from its forward; the gradients of gamma and beta stay
this rank's, for the reducer to average). The running statistics then
move alike on every rank.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .._platform import resolve_device
from ..ops._bn_common import _bn_scope, bn_group, bn_scope  # noqa: F401
from ..profiler import metrics as _metrics_mod
from . import collective as C
from .env import ParallelEnv
from .topology import build_mesh, get_hybrid_communicate_group

_parallel_env_initialized = False
_world_store = None  # the rendezvous store; the process group holds it too
_device: Optional[torch.device] = None


def _reset():
    global _parallel_env_initialized, _world_store, _device
    _parallel_env_initialized = False
    _world_store = None
    _device = None
    _loss_scope.clear()
    _bn_scope.clear()


def _backend_for(backend: Optional[str], device) -> str:
    """The backend a rank takes: the caller's, else gloo when
    PADDLE_DISTRI_BACKEND says so or the device is the CPU, else nccl
    (which needs a card: resolving the device raises without one)."""
    if backend is None:
        backend = os.environ.get("PADDLE_DISTRI_BACKEND", "").strip().lower()
    if not backend:
        dev = resolve_device(device)
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: the port runs 'nccl' (one "
                         f"card a rank) or 'gloo'")
    return backend


def _rank_device(env: ParallelEnv, backend: str, device) -> torch.device:
    """This rank's device: the CPU when asked for, else its card
    (``FLAGS_selected_gpus``). Under gloo several ranks may share a card;
    under nccl each rank needs its own."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if backend == "gloo" and device is None and \
            not torch.cuda.is_available():
        return torch.device("cpu")
    if device is not None and torch.device(device).index is not None:
        return resolve_device(device)
    resolve_device("cuda")  # raises without a card
    n = torch.cuda.device_count()
    idx = env.device_id
    if idx >= n:
        if backend == "nccl":
            raise RuntimeError(
                f"rank {env.rank}: FLAGS_selected_gpus={idx} but {n} "
                f"card(s) are visible; nccl takes one card a rank "
                f"(PADDLE_DISTRI_BACKEND=gloo lets ranks share one)")
        idx %= n
    return torch.device("cuda", idx)


def _master(env: ParallelEnv):
    """(host, port) of the rendezvous store: the first trainer endpoint,
    else MASTER_ADDR/MASTER_PORT, else (one trainer) a free local port."""
    if env.trainer_endpoints:
        host, port = env.trainer_endpoints[0].rsplit(":", 1)
        return host, int(port)
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"])
    if env.world_size > 1:
        raise RuntimeError(
            f"PADDLE_TRAINERS_NUM={env.world_size} but neither "
            f"PADDLE_TRAINER_ENDPOINTS nor MASTER_ADDR/MASTER_PORT names "
            f"the rendezvous; start the job with "
            f"python -m paddle_tpu_torch.distributed.launch")
    return "127.0.0.1", 0


def _rendezvous(env: ParallelEnv, timeout: float):
    """Rank 0 hosts the store, every rank connects, under the STORE retry
    policy (``PADDLE_TPU_STORE_{RETRIES,BACKOFF}``) with the fault site
    ``parallel.init``: a transient hiccup at job start costs a backoff,
    not the job."""
    import copy
    from ..fault import RetryPolicy
    from ..fault import site as _fault_site
    from .store import TCPStore

    policy = RetryPolicy.from_env("STORE", max_attempts=3, base_delay=0.05,
                                  max_delay=1.0)
    if policy.attempt_timeout is not None:
        # an abandoned attempt would keep binding/connecting underneath
        policy = copy.copy(policy)
        policy.attempt_timeout = None
    host, port = _master(env)

    def _do():
        _fault_site("parallel.init")
        return TCPStore(host, port, is_master=env.rank == 0,
                        world_size=env.world_size, timeout=timeout)

    return policy.call(_do, op="parallel.init")


def init_parallel_env(*, backend: Optional[str] = None, device=None,
                      timeout: float = 300.0) -> ParallelEnv:
    """Initialize this rank's process group (idempotent) and return the
    env view. ``backend``/``device`` choose gloo or the CPU (the default
    is nccl on this rank's card, and raises without one)."""
    global _parallel_env_initialized, _world_store, _device
    env = ParallelEnv()
    if _parallel_env_initialized:
        return env
    backend = _backend_for(backend, device)
    dev = _rank_device(env, backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        store = _rendezvous(env, timeout)
        # nccl: the communicator is made here, before any capture
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, store=store.torch_store,
                                rank=env.rank, world_size=env.world_size,
                                timeout=C._timeout(timeout), **kw)
        _world_store = store
    backend = dist.get_backend()
    n = dist.get_world_size()
    grid = build_mesh({"world": n}, devices=list(range(n)))
    C._set_default_group(C.Group(grid, ("world",), ranks=list(range(n)),
                                 name="default", pg=dist.group.WORLD,
                                 backend=backend))
    _device = dev
    _parallel_env_initialized = True
    return env


def get_backend() -> str:
    """The process group's backend ("nccl" or "gloo"); the reference
    returns "xla"."""
    return C._get_default_group().backend


def rank_device() -> torch.device:
    """This rank's device (after ``init_parallel_env``)."""
    C._get_default_group()
    return _device


def get_rank(group=None) -> int:
    """This process's rank (in ``group`` when given)."""
    if group is not None:
        return C._resolve(group).rank
    return C._proc_rank()


def get_world_size(group=None) -> int:
    if group is not None:
        return C._resolve(group).nranks
    return C._world_size()


def is_available() -> bool:
    return dist.is_available()


def parallel_device_count() -> int:
    """Devices the job spans: one a rank."""
    return get_world_size()


# ---------------------------------------------------------------------------
# data helpers
# ---------------------------------------------------------------------------
def _dp_group(mesh=None, axis: Optional[str] = None):
    """The data-parallel group this rank's rows are chosen by."""
    if mesh is None:
        hcg = get_hybrid_communicate_group()
        if hcg is not None:
            mesh = hcg.mesh
    if mesh is None:
        return C._get_default_group()
    axis = axis or ("dp" if "dp" in mesh.axis_names else mesh.axis_names[0])
    hcg = get_hybrid_communicate_group()
    if hcg is not None and hcg.mesh is mesh:
        return hcg._axis_group(axis)
    ranks = mesh.axis_ranks((axis,), C._proc_rank())
    return C.Group(mesh, (axis,), ranks=ranks)


def shard_batch(t, mesh=None, axis: Optional[str] = None):
    """This rank's rows of the global host batch ``t``: dim 0 split into
    equal parts over the data-parallel axis, part r for the rank at
    coordinate r (the shard the reference places on device r). A tensor
    comes back a tensor, an array an array."""
    g = _dp_group(mesh, axis)
    n, r = g.nranks, g.rank
    rows = t.shape[0]
    if rows % n:
        raise ValueError(f"shard_batch: {rows} rows do not split evenly "
                         f"over {n} data-parallel ranks")
    k = rows // n
    part = t[r * k:(r + 1) * k]
    if isinstance(t, torch.Tensor):
        return part.contiguous()
    return np.ascontiguousarray(part)


def replicate(t, mesh=None):
    """The same value on every rank: rank 0's, broadcast in place (a
    tensor) or returned (an array)."""
    if isinstance(t, torch.Tensor):
        C.broadcast(t, src=0)
        return t
    x = torch.from_numpy(np.ascontiguousarray(t))
    C.broadcast(x, src=0)
    return x.numpy()


# ---------------------------------------------------------------------------
# the global-batch loss scope
# ---------------------------------------------------------------------------
#: [(group, replicate)]: the data-parallel group F.cross_entropy reduces
#: its label count over, and whether it returns the group's loss value
#: (eager DataParallel) or this rank's share (a grouped TrainStep, which
#: takes the group's mean itself)
_loss_scope: list = []


def loss_group():
    """(group, replicate) of the data-parallel scope in force, or None."""
    return _loss_scope[-1] if _loss_scope else None


@contextlib.contextmanager
def loss_scope(group, replicate: bool):
    _loss_scope.append((group, replicate))
    try:
        yield
    finally:
        _loss_scope.pop()


def group_loss(local_sum: torch.Tensor, count: Optional[torch.Tensor],
               scope, clamp: bool = False) -> torch.Tensor:
    """The loss of the global batch from this rank's part of it:
    ``local_sum / count`` with ``count`` summed over the group (at least
    1 with ``clamp``; a sum when ``count`` is None). Its gradient is this
    rank's share (the group averages gradients, so the share is scaled by
    the group's size); its value is the group's loss when the scope
    replicates."""
    g, rep = scope
    n = g.nranks
    if count is not None:
        total = count.clone()
        C.raw_all_reduce(total, g)
        if clamp:
            total = total.clamp_min(1)
        share = local_sum * n / total
    else:
        share = local_sum * n
    if not rep:
        return share
    value = share.detach().clone()
    C.raw_all_reduce(value, g)
    return _GroupValue.apply(share, value / n)


class _GroupValue(torch.autograd.Function):
    """The group's loss value exactly (the same bits on every rank), with
    the gradient of this rank's share (``share + (value - share)`` would
    round differently on each rank)."""

    @staticmethod
    def forward(ctx, share, value):
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


# ---------------------------------------------------------------------------
# DataParallel
# ---------------------------------------------------------------------------
def _check_torch_batch_norm(layer: torch.nn.Module):
    """torch.nn's own batch norms run PyTorch's kernels on this rank's rows
    alone, outside the group, so a layer holding one in training mode
    raises: the reference normalizes by the global batch. The port's batch
    norms take the group's statistics."""
    bns = [name or type(m).__name__ for name, m in layer.named_modules()
           if m.training
           and isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    if bns:
        raise NotImplementedError(
            f"DataParallel over torch.nn batch norm in training mode "
            f"({bns[:3]}{' ...' if len(bns) > 3 else ''}): its statistics "
            f"would be this rank's, where the reference's are the global "
            f"batch's; use paddle_tpu_torch.nn.BatchNorm2D or "
            f"SyncBatchNorm, which take the group's")


class _Reducer:
    """Averages a layer's gradients over a group during the backward:
    the parameters are split into flat buckets (``bucket_mb``, the first
    parameters' bucket ``last_mb``: it is reduced last), each all-reduced
    asynchronously as soon as every gradient in it has accumulated, and
    at the end of the backward the results are waited for, divided by
    the group's size and written back into ``.grad``. A parameter whose
    gradient never comes fails the backward unless
    ``find_unused_parameters``, which reduces its bucket with zeros in its
    place (and leaves its ``.grad`` as the backward left it)."""

    def __init__(self, params, group, bucket_mb, last_mb, find_unused):
        self.group = group
        self.find_unused = find_unused
        params = [p for p in params if p.requires_grad]
        buckets, cur, size, cap = [], [], 0, float(last_mb) * 2 ** 20
        for p in params:  # forward order: the first bucket is reduced last
            nb = p.numel() * p.element_size()
            if cur and (size + nb > cap or p.dtype != cur[0].dtype
                        or p.device != cur[0].device):
                buckets.append(cur)
                cur, size, cap = [], 0, float(bucket_mb) * 2 ** 20
            cur.append(p)
            size += nb
        if cur:
            buckets.append(cur)
        self.buckets = buckets[::-1]  # the backward's order
        self._of = {id(p): i for i, b in enumerate(self.buckets) for p in b}
        self._hooks = [p.register_post_accumulate_grad_hook(self._ready)
                       for p in params]
        self._armed = False

    def prepare(self):
        """Arm the hooks for the next backward."""
        self._armed = True
        self._queued = False
        self._seen = [set() for _ in self.buckets]
        self._works = {}

    def _ready(self, p):
        if not self._armed:
            return
        if not self._queued:
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finish)
            self._queued = True
        b = self._of[id(p)]
        self._seen[b].add(id(p))
        if len(self._seen[b]) == len(self.buckets[b]):
            self._launch(b)

    def _launch(self, b):
        ps = self.buckets[b]
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in ps])
        C._account("all_reduce", self.group, flat)
        C._count("all_reduce")
        self._works[b] = (dist.all_reduce(flat, group=self.group.pg,
                                          async_op=True), flat)

    def _finish(self):
        self._armed = False
        missing = [i for i in range(len(self.buckets)) if i not in
                   self._works]
        if missing and not self.find_unused:
            names = [getattr(p, "param_name", tuple(p.shape))
                     for i in missing for p in self.buckets[i]
                     if id(p) not in self._seen[i]]
            raise RuntimeError(
                f"DataParallel: parameters {names[:4]} got no gradient in "
                f"this backward; pass find_unused_parameters=True")
        for i in missing:
            self._launch(i)
        t0 = time.perf_counter()
        n = self.group.nranks
        for b, (work, flat) in self._works.items():
            work.wait()
            flat.div_(n)
            off = 0
            for p in self.buckets[b]:
                k = p.numel()
                if p.grad is not None:
                    p.grad.copy_(flat[off:off + k].view_as(p))
                off += k
        if _metrics_mod.enabled():
            C._M_COLL_SECONDS.observe(time.perf_counter() - t0,
                                  kind="dp_grad_wait")
        self._works = {}
        # the step's loss has been taken: its scope ends with the backward
        _loss_scope[:] = [s for s in _loss_scope if not s[1]]


class DataParallel(torch.nn.Module):
    """paddle's ``DataParallel`` (``fluid/dygraph/parallel.py:411``), in
    the reference's slots.

    Wrapping broadcasts the layer's parameters and buffers from the
    group's rank 0. Feed each rank its rows (``shard_batch``); after
    ``loss.backward()`` the gradients hold the group's average, as the
    reference's are the gradients of the global batch's mean loss.
    ``comm_buffer_size`` / ``last_comm_buffer_size`` are the buckets' MB
    (``_Reducer``); ``strategy`` is taken and not used. ``state_dict``,
    ``set_state_dict``, ``parameters`` and ``named_parameters`` are the
    inner layer's, under its own names. A batch norm in training mode
    inside the layer normalizes by the group's statistics (``bn_scope``),
    as the reference's does by the global batch's; torch.nn's own batch
    norms cannot, and raise (``_check_torch_batch_norm``)."""

    def __init__(self, layers: torch.nn.Module, strategy=None,
                 comm_buffer_size=25, last_comm_buffer_size=1,
                 find_unused_parameters=False, group=None):
        super().__init__()
        self._layers = layers
        self.group = group
        self.find_unused_parameters = find_unused_parameters
        self.comm_buffer_size = comm_buffer_size
        self.last_comm_buffer_size = last_comm_buffer_size
        _check_torch_batch_norm(layers)
        g = C._resolve(group)
        self._group = g
        with torch.no_grad():
            for t in (*layers.parameters(), *layers.buffers()):
                C.broadcast(t.data, src=0, group=g)
        self._reducer = _Reducer(list(layers.parameters()), g,
                                 comm_buffer_size, last_comm_buffer_size,
                                 find_unused_parameters)

    def forward(self, *inputs, **kwargs):
        _check_torch_batch_norm(self._layers)
        if torch.is_grad_enabled():
            self._reducer.prepare()
        # the global-batch loss applies from here to the end of the
        # backward (or, with no backward, to the next forward); the
        # global-batch batch norm for the forward alone
        _loss_scope[:] = [(self._group, True)]
        with bn_scope(self._group):
            return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss  # the reducer averages the gradients

    def apply_collective_grads(self):
        pass  # done by the reducer during the backward

    # delegation: the inner layer's names, without a prefix
    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        fn = getattr(self._layers, "set_state_dict", None)
        return fn(*a, **k) if fn is not None \
            else self._layers.load_state_dict(*a, **k)

    def parameters(self, *a, **k):
        return self._layers.parameters(*a, **k)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)

    def buffers(self, *a, **k):
        return self._layers.buffers(*a, **k)

    def named_buffers(self, *a, **k):
        return self._layers.named_buffers(*a, **k)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(super().__getattr__("_layers"), name)
