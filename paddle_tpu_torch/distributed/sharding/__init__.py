"""ZeRO sharding (counterpart of ``paddle_tpu/distributed/sharding``).

The reference is one controller over a mesh: a ZeRO stage is a
*placement* there, not other arithmetic. The optimizer's
parameter-shaped slots (stage 1, ``"os"``, and stage 2, ``"os_g"``,
which in SPMD places alike) and at stage 3 (``"p_g_os"``) the
parameters too are laid out over the ``sharding`` axis, each array
along the first dimension that divides by the axis size
(``meta_parallel/engine.py`` ``_with_sharding_axis``); an array with no
such dimension stays replicated, never padded. XLA then moves the
gradients in and the parameters out.

The port runs one process a rank, and rank r holds shard r of each such
array (the rule of ``distributed/collective.py``). So it moves the data
itself, in flat buckets of at most 2**23 elements (the reference's
``buffer_max_size``):

* the gradients go in by a reduce-scatter (their group mean: the sharding
  axis is a data axis, so the step is the global batch's step), the
  optimizer updates this rank's shard of each parameter with its shard of
  each slot, and the updated shards go out by an all-gather;
* stage 2 drops each whole gradient once it is reduce-scattered (stage 1
  keeps it until ``clear_grad``): the port's one difference between the
  two, in memory only;
* stage 3 holds only shard r of each shardable parameter at rest. The
  model's forward gathers the whole parameters when it starts and lets
  them go when it ends (a parameter used twice, as GPT's tied ``wte``,
  is gathered once and its two gradients summed before the one
  reduce-scatter); the gradients reach the shards through the gather's
  backward, a reduce-scatter. Between forward and backward autograd holds
  what the backward needs, the whole weights included, as it does for
  any layer: a release after each sublayer would free nothing here.

On nccl the collectives are ``reduce_scatter_tensor`` and
``all_gather_into_tensor``, which a CUDA graph can hold (``jit.TrainStep``
captures them with the step). Under gloo a card's tensors go only
through ``all_reduce`` and ``broadcast`` (``collective._prepare``), so
there the reduce-scatter is an all-reduce and a slice and the all-gather
one broadcast from each owner; each kind counts under its own name in
``collective.launch_stats()``, and nothing is staged through host
memory.

The loss: while the model's forward and its backward run,
``F.cross_entropy`` divides by the label count of the group
(``parallel.group_loss``), as under ``DataParallel``, so a rank may feed
its own rows (``shard_batch``) or the same batch as every other rank and
get the reference's numbers.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import collective as C
from .. import parallel as _parallel
from ...ops import _bn_common
from ..topology import (HybridCommunicateGroup, get_hybrid_communicate_group,
                        set_hybrid_communicate_group)

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]

_LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}
AXIS = "sharding"
#: elements of whole arrays a bucket holds: the reference's buffer_max_size
BUCKET_ELEMS = 2 ** 23


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
def shard_dim(shape, n: int) -> Optional[int]:
    """The dimension rank r's shard is cut along: the first whose size
    divides by ``n`` (and is at least ``n``), or None (held whole). At
    ``n`` 1 that is dimension 0, a shard equal to the whole."""
    for i, d in enumerate(shape):
        if d % n == 0 and d >= n:
            return i
    return None


def sharding_spec(shape, n: int) -> Optional[tuple]:
    """The reference's PartitionSpec of such an array
    (``_with_sharding_axis(P(), axis, shape, {axis: n})``), None when it
    is not sharded (an axis of size 1 places nothing)."""
    i = shard_dim(shape, n) if n > 1 else None
    if i is None:
        return None
    return tuple(AXIS if j == i else None for j in range(len(shape)))


class ShardedTensor:
    """One rank's piece of a global array: ``local`` holds the indices
    ``box`` ([[start, stop], ...] a dimension) of an array of ``shape``,
    placed by ``spec`` (the reference's PartitionSpec, None when
    replicated). The sharded checkpoint writes it as one chunk."""

    __slots__ = ("shape", "box", "local", "spec")

    def __init__(self, shape, box, local, spec=None):
        self.shape = tuple(int(d) for d in shape)
        self.box = [[int(a), int(b)] for a, b in box]
        self.local = local
        self.spec = None if spec is None else tuple(spec)

    @property
    def whole(self) -> bool:
        return all(a == 0 and b == d for (a, b), d in
                   zip(self.box, self.shape))

    def __repr__(self):
        return (f"ShardedTensor(shape={self.shape}, box={self.box}, "
                f"spec={self.spec})")


class _Entry:
    __slots__ = ("name", "shape", "dim", "k", "shard_shape", "numel", "off")

    def __init__(self, name, shape, n):
        self.name = name
        self.shape = tuple(int(d) for d in shape)
        self.dim = shard_dim(self.shape, n)
        if self.dim is None:
            self.k = None
            self.shard_shape = self.shape
        else:
            self.k = self.shape[self.dim] // n
            self.shard_shape = (self.shape[:self.dim] + (self.k,)
                                + self.shape[self.dim + 1:])
        self.numel = int(np.prod(self.shard_shape, dtype=np.int64))
        self.off = 0


class _Bucket:
    __slots__ = ("dtype", "device", "entries", "numel")

    def __init__(self, dtype, device):
        self.dtype, self.device = dtype, device
        self.entries: List[_Entry] = []
        self.numel = 0


def _split(t: torch.Tensor, e: _Entry, n: int) -> torch.Tensor:
    """A whole array as [n, *shard shape]: row j is shard j (a view of a
    contiguous ``t``)."""
    d = e.dim
    return t.reshape(e.shape[:d] + (n, e.k) + e.shape[d + 1:]).movedim(d, 0)


class ZeroLayout:
    """Where each array of a set lives over a group, and the bucketed
    collectives that move them: shard r of a sharded array on rank r,
    the whole of the others everywhere. ``arrays`` is [(name, whole shape,
    dtype, device)], in the order the buckets take them."""

    def __init__(self, arrays, group):
        self.group = group
        self.n, self.r = group.nranks, group.rank
        self.entries: Dict[str, _Entry] = {}
        self.sharded: List[_Bucket] = []
        self.replicated: List[_Bucket] = []
        for name, shape, dtype, device in arrays:
            e = _Entry(name, shape, self.n)
            self.entries[name] = e
            bl = self.replicated if e.dim is None else self.sharded
            per = 1 if e.dim is None else self.n  # whole elements a shard's
            b = bl[-1] if bl else None
            if (b is None or b.dtype != dtype or b.device != device
                    or (b.numel + e.numel) * per > BUCKET_ELEMS):
                b = _Bucket(dtype, device)
                bl.append(b)
            e.off = b.numel
            b.entries.append(e)
            b.numel += e.numel

    # -- the pieces of one array -----------------------------------------
    def box(self, name) -> List[List[int]]:
        e = self.entries[name]
        box = [[0, d] for d in e.shape]
        if e.dim is not None:
            box[e.dim] = [self.r * e.k, (self.r + 1) * e.k]
        return box

    def spec(self, name) -> Optional[tuple]:
        return sharding_spec(self.entries[name].shape, self.n)

    def shard_of(self, t: torch.Tensor, name) -> torch.Tensor:
        """This rank's shard of the whole ``t`` (a view)."""
        e = self.entries[name]
        if e.dim is None:
            return t
        return t.narrow(e.dim, self.r * e.k, e.k)

    def local_of(self, value, name) -> torch.Tensor:
        """This rank's piece from a whole array (tensor or numpy) or from
        a ShardedTensor holding this rank's box or the whole."""
        e = self.entries[name]
        if isinstance(value, ShardedTensor):
            if value.box == self.box(name):
                return _as_tensor(value.local)
            if not value.whole:
                raise ValueError(f"{name}: a piece {value.box} of "
                                 f"{value.shape} is not this rank's "
                                 f"{self.box(name)}")
            value = value.local
        t = _as_tensor(value)
        if tuple(t.shape) != e.shape:
            raise ValueError(f"{name}: {tuple(t.shape)}, the model holds "
                             f"{e.shape}")
        return self.shard_of(t, name)

    def sharded_tensor(self, local, name) -> ShardedTensor:
        return ShardedTensor(self.entries[name].shape, self.box(name),
                             local, self.spec(name))

    # -- collectives ----------------------------------------------------------
    def _gloo_card(self, t) -> bool:
        """Does ``t`` go through gloo on a card (all_reduce and broadcast
        only)?"""
        return self.group.backend == "gloo" and t.is_cuda

    def _comm(self, kind, out, inp):
        g = self.group
        if self._gloo_card(out):
            if kind == "reduce_scatter":
                C._count("reduce_scatter_as_all_reduce")
                C._account("reduce_scatter_as_all_reduce", g, inp)
                dist.all_reduce(inp, group=g.pg)
                out.copy_(inp[self.r])
            else:
                for j in range(self.n):
                    C._count("all_gather_as_broadcast")
                    C._account("all_gather_as_broadcast", g, out[j])
                    if j == self.r:
                        out[j].copy_(inp)
                    dist.broadcast(out[j], src=g.ranks[j], group=g.pg)
            return
        C._count(kind)
        C._account(kind, g, inp)
        if g.backend == "nccl":
            if kind == "reduce_scatter":
                dist.reduce_scatter_tensor(out, inp.view(-1), group=g.pg)
            else:
                dist.all_gather_into_tensor(out.view(-1), inp, group=g.pg)
        elif kind == "reduce_scatter":
            dist.reduce_scatter(out, list(inp.unbind(0)), group=g.pg)
        else:
            dist.all_gather(list(out.unbind(0)), inp, group=g.pg)

    @torch.no_grad()
    def reduce_grads(self, grads: dict, release: bool = False,
                     sharded: bool = True, replicated: bool = True) -> dict:
        """{name: shard of the group's mean gradient} from this rank's
        whole gradients (a missing one counts as zeros): one
        reduce-scatter a bucket of sharded arrays, one all-reduce a bucket
        of the others (either kind alone when the other flag is off).
        ``release`` drops each whole gradient from ``grads`` once its
        bucket is reduced."""
        n, out = self.n, {}
        for b in self.sharded if sharded else ():
            inp = torch.empty((n, b.numel), dtype=b.dtype, device=b.device)
            dst, src = [], []
            for e in b.entries:
                g = grads.get(e.name)
                view = inp[:, e.off:e.off + e.numel].view(
                    (n,) + e.shard_shape)
                if g is None:
                    view.zero_()
                    continue
                dst.append(view)
                src.append(_split(g, e, n))
            if dst:
                torch._foreach_copy_(dst, src)
            flat = torch.empty(b.numel, dtype=b.dtype, device=b.device)
            self._comm("reduce_scatter", flat, inp)
            del inp
            flat.div_(n)
            for e in b.entries:
                out[e.name] = flat[e.off:e.off + e.numel].view(e.shard_shape)
                if release:
                    grads.pop(e.name, None)
        for b in self.replicated if replicated else ():
            flat = torch.zeros(b.numel, dtype=b.dtype, device=b.device)
            dst, src = [], []
            for e in b.entries:
                g = grads.get(e.name)
                if g is not None:
                    dst.append(flat[e.off:e.off + e.numel].view(e.shape))
                    src.append(g)
            if dst:
                torch._foreach_copy_(dst, src)
            C._count("all_reduce")
            C._account("all_reduce", self.group, flat)
            dist.all_reduce(flat, group=self.group.pg)
            flat.div_(n)
            for e in b.entries:
                out[e.name] = flat[e.off:e.off + e.numel].view(e.shape)
                if release:
                    grads.pop(e.name, None)
        return out

    def _gather(self, b: _Bucket, shards: dict) -> torch.Tensor:
        """[n, bucket] of every rank's shards of bucket ``b``."""
        inp = torch.empty(b.numel, dtype=b.dtype, device=b.device)
        torch._foreach_copy_(
            [inp[e.off:e.off + e.numel].view(e.shard_shape)
             for e in b.entries], [shards[e.name] for e in b.entries])
        out = torch.empty((self.n, b.numel), dtype=b.dtype, device=b.device)
        self._comm("all_gather", out, inp)
        return out

    @torch.no_grad()
    def gather_into(self, wholes: dict) -> None:
        """Bring every rank's updated shard into the whole arrays
        ``wholes`` (contiguous, written in place): one all-gather a
        bucket."""
        n = self.n
        for b in self.sharded:
            out = self._gather(b, {e.name: self.shard_of(wholes[e.name],
                                                         e.name)
                                   for e in b.entries})
            torch._foreach_copy_(
                [_split(wholes[e.name], e, n) for e in b.entries],
                [out[:, e.off:e.off + e.numel].view((n,) + e.shard_shape)
                 for e in b.entries])

    @torch.no_grad()
    def gather(self, shards: dict) -> dict:
        """{name: a new whole array} from this rank's shards (the others
        of ``shards``, held whole, come back as they are)."""
        n, wholes = self.n, {}
        for b in self.sharded:
            out = self._gather(b, shards)
            ws = [torch.empty(e.shape, dtype=b.dtype, device=b.device)
                  for e in b.entries]
            torch._foreach_copy_(
                [_split(w, e, n) for w, e in zip(ws, b.entries)],
                [out[:, e.off:e.off + e.numel].view((n,) + e.shard_shape)
                 for e in b.entries])
            wholes.update((e.name, w) for e, w in zip(b.entries, ws))
        for b in self.replicated:
            for e in b.entries:
                wholes[e.name] = shards[e.name]
        return wholes

    @torch.no_grad()
    def gather_one(self, shard: torch.Tensor, name) -> torch.Tensor:
        """The whole array of one sharded tensor (a slot read for a state
        dict): one all-gather."""
        e = self.entries[name]
        if e.dim is None:
            return shard
        b = _Bucket(shard.dtype, shard.device)
        one = _Entry(name, e.shape, self.n)
        b.entries, b.numel = [one], one.numel
        out = self._gather(b, {name: shard})
        whole = torch.empty(e.shape, dtype=shard.dtype, device=shard.device)
        _split(whole, e, self.n).copy_(out.view((self.n,) + e.shard_shape))
        return whole


def _as_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.array(v))


# ---------------------------------------------------------------------------
# the group
# ---------------------------------------------------------------------------
def _get_group(group=None):
    """The sharding group: ``group`` when given; else the active topology's
    ``sharding`` axis, which must be named there and, in a world of more
    than one rank, larger than 1; else (no topology) a new one with the
    whole world on that axis. A user's topology is never replaced."""
    if group is not None:
        return C._resolve(group)
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        C._get_default_group()
        hcg = HybridCommunicateGroup(dims={AXIS: C._world_size()})
        set_hybrid_communicate_group(hcg)
    elif AXIS not in hcg.mesh.axis_names or (
            hcg.axis_size(AXIS) <= 1 and C._world_size() > 1):
        raise ValueError(
            f"group_sharded_parallel needs a 'sharding' axis in the active "
            f"topology (got {dict(hcg.mesh.shape)}); include "
            f"sharding_degree in HybridCommunicateGroup or pass group=")
    return hcg.get_sharding_parallel_group()


# ---------------------------------------------------------------------------
# the model: stage 3's gather, the global-batch loss scope
# ---------------------------------------------------------------------------
class _GatherParams(torch.autograd.Function):
    """Whole parameters from this rank's shards; backward: the shards of
    the group's mean gradient (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, layout, names, *shards):
        ctx.layout, ctx.names = layout, names
        wholes = layout.gather(dict(zip(names, shards)))
        return tuple(wholes[k] for k in names)

    @staticmethod
    def backward(ctx, *grads):
        got = ctx.layout.reduce_grads(
            {k: g for k, g in zip(ctx.names, grads) if g is not None},
            replicated=False)
        return (None, None, *(got[k] for k in ctx.names))


class _ModelHandle:
    """What ``group_sharded_parallel`` hooks into the model: the loss and
    batch-norm scopes of its forward and, at stage 3, its parameters'
    shards and their gather."""

    def __init__(self, model, group, stage):
        self.group, self.stage = group, stage
        self._active = True
        self.whole_shapes = {id(p): tuple(p.shape)
                             for p in model.parameters()}
        self._uses = {}   # id(p) -> [(module, attribute)]
        for m in model.modules():
            for a, p in m._parameters.items():
                if p is not None:
                    self._uses.setdefault(id(p), []).append((m, a))
        self._named = [(k, p) for k, p in model.named_parameters()]
        self.layout = None
        self._sharded = []  # stage 3: the parameters held as shards
        if stage >= 3:
            self.layout = ZeroLayout(
                [(k, tuple(p.shape), p.dtype, p.device)
                 for k, p in self._named], group)
            self._sharded = [(k, p) for k, p in self._named
                             if self.layout.entries[k].dim is not None]
            with torch.no_grad():
                for k, p in self._sharded:
                    p.data = self.layout.shard_of(p.data, k).clone()
            model._register_state_dict_hook(self._state_dict_hook)
            model._register_load_state_dict_pre_hook(self._load_pre_hook)
        self._gathered = []
        model.register_forward_pre_hook(self._pre)
        model.register_forward_hook(self._post, always_call=True)

    @contextlib.contextmanager
    def suspended(self):
        """The hooks do nothing while the block runs (``jit.TrainStep``
        drives the model itself)."""
        prev, self._active = self._active, False
        try:
            yield
        finally:
            self._active = prev

    def _pre(self, module, inputs):
        if not self._active:
            return
        _parallel._loss_scope[:] = [(self.group, True)]
        _bn_common._bn_scope.append(self.group)
        if self._sharded:
            names = [k for k, _ in self._sharded]
            wholes = _GatherParams.apply(self.layout, names,
                                         *(p for _, p in self._sharded))
            for (k, p), w in zip(self._sharded, wholes):
                for m, a in self._uses[id(p)]:
                    object.__setattr__(m, a, w)
                    self._gathered.append((m, a))

    def _post(self, module, inputs, output):
        if not self._active:
            return
        _bn_common._bn_scope.pop()
        for m, a in self._gathered:
            m.__dict__.pop(a, None)
        self._gathered = []

    # stage 3's model state dict holds whole arrays, as the reference's
    def _state_dict_hook(self, module, sd, prefix, local_metadata):
        for k, p in self._sharded:
            key = prefix + k
            if key in sd:
                sd[key] = self.layout.gather_one(sd[key].detach(), k)
        return sd

    def _load_pre_hook(self, sd, prefix, *args):
        for k, _ in self._sharded:
            key = prefix + k
            if key in sd:
                sd[key] = self.layout.local_of(sd[key], k)

    def sharded_state(self) -> dict:
        """{name: ShardedTensor} of the parameters at stage 3 (each rank's
        shard with its box), for the sharded checkpoint."""
        return {k: self.layout.sharded_tensor(p.detach(), k)
                for k, p in self._named}


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------
class _ShardedStepMixin:
    """The wrapped optimizer (the reference's ``_ShardedStepMixin``):
    ``step`` reduces the gradients to this rank's shards, updates the
    shards of the parameters with the shards of the slots (made on the
    shard when a parameter first has a gradient) and, below stage 3,
    gathers the parameters back; ``state_dict`` gives whole arrays and
    ``set_state_dict`` takes them (or this rank's ShardedTensors) and
    keeps the shard. Every other attribute is the inner optimizer's."""

    def __init__(self, opt, handle: _ModelHandle):
        self._opt = opt
        self._zero = handle
        self.group, self.stage = handle.group, handle.stage
        params = opt._parameter_list
        self._names = {id(p): opt._param_name(p, i)
                       for i, p in enumerate(params)}
        self.layout = ZeroLayout(
            [(self._names[id(p)], handle.whole_shapes.get(id(p),
                                                          tuple(p.shape)),
              p.dtype, p.device) for p in params], handle.group)

    def __getattr__(self, name):
        return getattr(self._opt, name)

    def _shard(self, p):
        """The tensor of ``p`` this rank updates: its shard (at stage 3 the
        parameter itself holds it)."""
        if self.stage >= 3:
            return p
        return self.layout.shard_of(p, self._names[id(p)])

    @torch.no_grad()
    def step(self):
        opt = self._opt
        opt._step_count += 1
        _parallel._loss_scope[:] = []  # the step's loss has been taken
        todo = [p for p in opt._parameter_list
                if p.requires_grad and p.grad is not None]
        if self.stage >= 3:
            # the gather's backward has reduced the sharded ones already
            grads = {self._names[id(p)]: p.grad for p in todo}
            grads.update(self.layout.reduce_grads(grads, sharded=False))
        else:
            # every rank takes part in every bucket, a missing gradient
            # as zeros
            whole = {self._names[id(p)]: p.grad for p in todo}
            grads = self.layout.reduce_grads(whole)
            if self.stage == 2:
                for p in todo:
                    p.grad = None
        # the plain eager step's own form (``Optimizer.step``): one update
        # a parameter with Python scalars, on this rank's shard
        lr = opt.get_lr()
        for p in todo:
            k = self._names[id(p)]
            shard = self._shard(p)
            slots = opt._slots.get(id(p))
            if slots is None:
                slots = opt._init_slots(shard)
            opt._slots[id(p)] = opt._apply(
                [shard], [grads[k]], [slots], lr, opt._step_count,
                opt._param_kw(k))[1][0]
        if self.stage < 3:
            self.layout.gather_into({self._names[id(p)]: p.data
                                     for p in opt._parameter_list})

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self._opt.clear_grad()
        return [], []

    def state_dict(self) -> dict:
        """The reference's keys, each slot whole (every rank gathers)."""
        sd = self._opt.state_dict()
        for i, p in enumerate(self._opt._parameter_list):
            k = self._names[id(p)]
            for s, v in (self._opt._slots.get(id(p)) or {}).items():
                sd[f"{k}.{s}"] = self.layout.gather_one(v, k)
        return sd

    def set_state_dict(self, sd: dict):
        """Load whole slots (or this rank's ShardedTensors) and keep the
        shards."""
        plain = {k: (v.local if isinstance(v, ShardedTensor) and v.whole
                     else v) for k, v in sd.items()}
        pieces = {k: v for k, v in plain.items()
                  if isinstance(v, ShardedTensor)}
        self._opt.set_state_dict({k: v for k, v in plain.items()
                                  if k not in pieces})
        for p in self._opt._parameter_list:
            k = self._names[id(p)]
            slots = dict(self._opt._slots.get(id(p)) or {})
            for key, v in pieces.items():
                if key.startswith(k + "."):
                    slots[key[len(k) + 1:]] = v
            if slots:
                self._opt._slots[id(p)] = {
                    s: self.layout.local_of(v, k).to(p.device).clone()
                    for s, v in slots.items()}

    def sharded_state_dict(self) -> dict:
        """``state_dict`` with each slot as this rank's ShardedTensor (no
        collective): the form the sharded checkpoint writes."""
        sd = self._opt.state_dict()
        for p in self._opt._parameter_list:
            k = self._names[id(p)]
            for s, v in (self._opt._slots.get(id(p)) or {}).items():
                sd[f"{k}.{s}"] = self.layout.sharded_tensor(v.detach(), k)
        return sd


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def group_sharded_parallel(model, optimizer, level: str, scaler=None,
                           group=None, offload: bool = False,
                           sync_buffers: bool = False,
                           buffer_max_size: int = 2 ** 23,
                           segment_size: int = 2 ** 20,
                           sync_comm: bool = False,
                           dp_group=None, **kwargs):
    """(model, optimizer, scaler) with ZeRO's placement over the
    ``sharding`` group (module docstring), in the reference's slots.
    ``sync_buffers``, ``buffer_max_size``, ``segment_size``, ``sync_comm``,
    ``dp_group`` and any keyword the reference takes and ignores raise
    unless left at their defaults; ``offload`` raises, as the reference's
    does. The model is returned with its hooks, the optimizer wrapped."""
    if level not in _LEVELS:
        raise ValueError(f"level must be one of {sorted(_LEVELS)}, "
                         f"got {level!r}")
    if offload:
        raise NotImplementedError(
            "CPU offload: not ported (the reference raises too)")
    asked = [k for k, v, d in (
        ("sync_buffers", sync_buffers, False),
        ("buffer_max_size", buffer_max_size, 2 ** 23),
        ("segment_size", segment_size, 2 ** 20),
        ("sync_comm", sync_comm, False), ("dp_group", dp_group, None))
        if v != d] + sorted(kwargs)
    if asked:
        raise NotImplementedError(
            f"group_sharded_parallel: {', '.join(asked)} are taken and not "
            f"used by the reference; only their defaults are accepted")
    if scaler is not None:
        raise NotImplementedError(
            "group_sharded_parallel with a GradScaler: its finite check "
            "over sharded gradients is not ported (bf16 needs no scaler)")
    if getattr(optimizer, "_grad_clip", None) is not None:
        raise NotImplementedError(
            "group_sharded_parallel with grad_clip: the global norm over "
            "sharded gradients is not ported")
    if isinstance(optimizer, _ShardedStepMixin):
        raise ValueError("the optimizer is already group-sharded")
    g = _get_group(group)
    handle = _ModelHandle(model, g, _LEVELS[level])
    model._group_sharded = handle
    return model, _ShardedStepMixin(optimizer, handle), scaler


def save_group_sharded_model(model, output: str, optimizer=None):
    """Every rank gathers; group rank 0 alone writes
    ``output/model.pdparams`` (and ``model.pdopt``) in ``framework/io``'s
    format, which the reference's ``paddle.load`` reads."""
    from ...framework.io import save
    assert not output.endswith((".pdmodel", ".pdparams")), \
        "output is a directory"
    handle = getattr(model, "_group_sharded", None)
    group = handle.group if handle is not None else C._get_default_group()
    state = model.state_dict()
    opt_state = optimizer.state_dict() if optimizer is not None else None
    if group.rank == 0:
        os.makedirs(output, exist_ok=True)
        save({k: v.detach().cpu() for k, v in state.items()},
             os.path.join(output, "model.pdparams"))
        if opt_state is not None:
            save(opt_state, os.path.join(output, "model.pdopt"))
