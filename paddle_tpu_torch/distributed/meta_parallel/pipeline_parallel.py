"""Pipeline parallelism — a host-driven 1F1B over the ``pp`` group
(counterpart of ``paddle_tpu/distributed/meta_parallel/pipeline_parallel.py``).

The reference compiles the whole pipeline into one SPMD program: block
parameters stacked ``[S, L/S, ...]`` over the ``pp`` axis, a stage buffer
rotated by ``jnp.roll`` (a collective-permute) once a tick, and
``jax.grad`` through the schedule for the reverse pipeline. The port is
one process a rank (rank r of the port is device r of the reference's
group), so it runs the schedule PaddlePaddle itself runs
(``PipelineParallel.forward_backward_pipeline``): **1F1B**, warm-up
forwards, then one forward and one backward in turn, then the cool-down
backwards, with the boundary activations sent forward and their
gradients sent back between adjacent stages. It means what the
reference's program means:

* stage ``s`` holds blocks ``[offsets[s], offsets[s] + counts[s])`` of
  the homogeneous region (``_BlockRun``), with masters and optimizer slots
  for those alone; the edge parameters (embeddings, final norm and head,
  or a ``PipelineLayer``'s layers outside its scan region) are replicated
  on every stage, stage 0 runs ``pre`` and stage ``S-1`` runs ``post`` and
  the loss. Edge gradients are summed over the pp group (so a tied weight
  used at both ends needs no special case) and stay bit-identical on
  every pp rank;
* the loss is the mean over the M micro-batches of each one's loss, each
  taken over the dp group of the last stage (``parallel.loss_scope``),
  and the step returns it on every rank (a broadcast from stage
  ``S-1``); block gradients are averaged over dp, edge gradients summed
  over pp and then averaged over dp;
* every stage's forward and the loss run under ``recompute`` (the
  reference's ``jax.checkpoint`` at l.309 and 328): only the boundary
  activations live across the schedule, and stage ``s`` holds at most
  ``S - s`` micro-batches' inputs at once (``peak_in_flight``).

The transfers: the boundary's shape and type go once a batch signature,
ahead of the first activation. Under nccl (one card a rank) the
activations and gradients go device to device through
``batch_isend_irecv``; gloo takes a card's tensors only in all-reduce and
broadcast, so under gloo they are staged through host tensors, counted in
``collective.launch_stats()`` as "pp_send_host" / "pp_recv_host" apart
from the device-to-device "pp_send" / "pp_recv". Both ends of a link post
their transfers in the one schedule's order.

Each micro-batch's stage forward and backward run op by op (the stage
steps are not captured as CUDA graphs). Tensor and sequence parallelism
and ZeRO-1 alongside the pipeline raise, naming their ROADMAP items.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ...profiler import health as _health
from ...utils.envparse import env_bool
from .. import collective as C
from .. import parallel as _parallel
from ..fleet.utils import _swapped, recompute
from ..topology import HybridCommunicateGroup, get_hybrid_communicate_group
from ._strategy import (_apply_scaled_update, _axis_sizes,
                        _build_health_probe, _data_axes_of, _health_grads,
                        _note_health, _parse_strategy, _scaler_config)
from .pp_layers import PipelineLayer

_TP = "ROADMAP A11 item 2 (tensor parallelism)"
_SP = "ROADMAP A11 item 3 (sequence parallelism)"
_ZERO = "ROADMAP A11 item 6 (ZeRO-1 alongside the pipeline)"

_BN = ("BatchNorm-family layers keep running statistics that the 1F1B "
       "schedule does not carry between stages; use LayerNorm/GroupNorm "
       "in pipelined models")

# the boundary's type in the shape header
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32)


def _uniform_counts(n: int, stages: int) -> List[int]:
    """n layers over ``stages`` parts, the remainder to the earlier stages
    (PaddlePaddle's ``SegmentLayers.uniform``, pp_layers.py:63)."""
    per, rem = divmod(n, stages)
    return [per + (1 if s < rem else 0) for s in range(stages)]


class _BlockRun:
    """The homogeneous region split over the stages: ``counts[s]`` blocks
    on stage ``s``, from block ``offsets[s]`` (uneven counts as the
    reference's ``SegmentLayers``)."""

    def __init__(self, block_layers: Sequence[torch.nn.Module],
                 names: Sequence[str], num_stages: int,
                 counts: Optional[Sequence[int]] = None):
        self.num_layers = len(block_layers)
        self.num_stages = num_stages
        if counts is None:
            counts = _uniform_counts(self.num_layers, num_stages)
        counts = list(counts)
        assert len(counts) == num_stages and sum(counts) == self.num_layers, (
            f"stage counts {counts} do not cover {self.num_layers} layers "
            f"over {num_stages} stages")
        assert min(counts) >= 1, (
            f"every pipeline stage needs at least one layer, got {counts}")
        self.counts = counts
        self.offsets = [sum(counts[:s]) for s in range(num_stages)]
        for lyr in block_layers:
            bufs = [k for k, _ in lyr.named_buffers()]
            if bufs:
                raise ValueError(
                    f"pipeline blocks must be buffer-free: found buffers "
                    f"{bufs}. {_BN}")
        self.layers = list(block_layers)
        self.prefixes = list(names)  # each block's name in the model
        self.keys = [k for k, _ in block_layers[0].named_parameters()]

    def stage_layers(self, s: int) -> List[torch.nn.Module]:
        o = self.offsets[s]
        return self.layers[o:o + self.counts[s]]

    def stage_names(self, s: int) -> List[str]:
        """The full parameter names of stage ``s``'s blocks."""
        o = self.offsets[s]
        return [f"{pref}.{k}" if pref else k
                for pref in self.prefixes[o:o + self.counts[s]]
                for k in self.keys]


def _gpt_like_parts(model: torch.nn.Module):
    """(pre_fn, blocks, block_prefixes, post_fn) for a model with the
    ``pipeline_pre`` / ``blocks`` / ``pipeline_post`` protocol
    (``models/gpt.py``) or a PipelineLayer's scan region."""
    if isinstance(model, PipelineLayer):
        start, stop = model.scan_region()
        layers = list(model.run_function)
        assert stop > start, "PipelineLayer has no homogeneous scan region"

        def pre(m, *inputs):
            x = inputs[0] if len(inputs) == 1 else inputs
            for lyr in layers[:start]:
                x = lyr(x)
            return x

        def post(m, x):
            for lyr in layers[stop:]:
                x = lyr(x)
            return x
        prefixes = [f"run_function.{i}" for i in range(start, stop)]
        return pre, layers[start:stop], prefixes, post
    if hasattr(model, "pipeline_pre") and hasattr(model, "pipeline_post"):
        blocks = list(model.blocks)
        prefixes = [f"blocks.{i}" for i in range(len(blocks))]
        return (type(model).pipeline_pre, blocks, prefixes,
                type(model).pipeline_post)
    raise TypeError(
        f"{type(model).__name__} is not pipeline-able: pass a PipelineLayer "
        "or implement pipeline_pre(inputs)->hidden / blocks / "
        "pipeline_post(hidden)->out")


class _Region(torch.nn.Module):
    """A function over some modules, as one ``recompute`` region: the
    modules' parameters (the step's compute tensors while it runs) enter
    the region as its inputs."""

    def __init__(self, fn: Callable, modules: Sequence[torch.nn.Module]):
        super().__init__()
        self.mods = torch.nn.ModuleList(modules)
        object.__setattr__(self, "_fn", fn)

    def forward(self, *args):
        return self._fn(*args)


class _Link:
    """The point-to-point transfers of one rank over its pp group: the
    boundary activations forward and their gradients back, each posted
    as one batch of isend/irecv and waited for. Under gloo with a card's
    tensors they are staged through host tensors. ``stats`` sums count,
    bytes and seconds."""

    def __init__(self, group, device: torch.device):
        self.g = group
        self.device = device
        self.staged = group.backend == "gloo" and device.type == "cuda"
        self.kind = "pp_send_host" if self.staged else "pp_send"
        self.stats = dict(count=0, bytes=0, seconds=0.0)

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as gloo carries it: 2-byte floats as int16 bits."""
        if self.g.backend == "gloo" and t.element_size() == 2 \
                and t.is_floating_point():
            return t.view(torch.int16)
        return t

    def exchange(self, sends, recvs) -> List[torch.Tensor]:
        """Post ``sends`` ([(tensor, dst group rank)]) and ``recvs``
        ([(shape, dtype, src group rank)]) together and wait for all;
        returns the received tensors on the device."""
        t0 = time.perf_counter()
        host = torch.device("cpu") if self.staged else self.device
        ops, bufs = [], []
        for t, dst in sends:
            payload = t.detach().contiguous()
            if self.staged:
                payload = payload.cpu()
            ops.append(dist.P2POp(dist.isend, self._wire(payload),
                                  self.g.ranks[dst], group=self.g.pg))
            C._count(self.kind)
            C._account(self.kind, self.g, payload)
            self.stats["count"] += 1
            self.stats["bytes"] += payload.numel() * payload.element_size()
        for shape, dtype, src in recvs:
            buf = torch.empty(shape, dtype=dtype, device=host)
            bufs.append(buf)
            ops.append(dist.P2POp(dist.irecv, self._wire(buf),
                                  self.g.ranks[src], group=self.g.pg))
            kind = self.kind.replace("send", "recv")
            C._count(kind)
            C._account(kind, self.g, buf)
            self.stats["count"] += 1
            self.stats["bytes"] += buf.numel() * buf.element_size()
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        out = [b.to(self.device) if self.staged else b for b in bufs]
        self.stats["seconds"] += time.perf_counter() - t0
        return out


def _bcast(t: torch.Tensor, g, src: int, kind: str) -> None:
    """Broadcast ``t`` in place from group rank ``src``, counted as
    ``kind``."""
    C._count(kind)
    C._account(kind, g, t)
    dist.broadcast(t, src=g.ranks[src], group=g.pg)


class PipelineParallelTrainStep:
    """Forward, backward and the optimizer update of a pipelined model,
    one call a global batch: ``loss = step(*inputs, labels)``.

    ``model`` is a ``PipelineLayer`` or has the ``pipeline_pre`` /
    ``blocks`` / ``pipeline_post`` protocol, built alike on every rank
    (from one seed, or loaded). ``hcg`` (default: the one set with
    ``set_hybrid_communicate_group``) must have a ``pp`` axis above 1; a
    ``dp`` axis splits each micro-batch's rows. ``num_micro`` micro-batches
    a step (default: ``strategy.pipeline_configs["accumulate_steps"]`` and
    at least the stage count). ``strategy.amp`` trains on bf16 casts of
    fp32 masters (O2), or with amp dtype "float16" on fp16 casts under
    dynamic loss scaling (``scaler_state``), the update skipped on every
    rank when any stage's gradient is not finite. ``health`` folds in the
    step sentinel (``last_health``: the reference's loss and gradient
    norm). ``donate`` is taken and not used, as ``jit.TrainStep`` takes
    it. The step runs on the model's device."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 hcg: Optional[HybridCommunicateGroup] = None,
                 strategy=None, num_micro: Optional[int] = None,
                 donate: bool = True, health=None, fused_opt=None):
        del donate
        self.layer = model
        self.optimizer = optimizer
        self._loss_fn = loss_fn
        self.hcg = hcg or get_hybrid_communicate_group()
        assert self.hcg is not None, (
            "no topology: set_hybrid_communicate_group("
            "HybridCommunicateGroup(dims={'pp': ...})) first")
        self.mesh = self.hcg.mesh
        sizes = _axis_sizes(self.mesh)
        if sizes.get("mp", 1) > 1:
            raise NotImplementedError(
                f"pipeline with an mp axis of {sizes['mp']}: tensor "
                f"parallelism waits for {_TP}")
        if sizes.get("sp", 1) > 1:
            raise NotImplementedError(
                f"pipeline with an sp axis of {sizes['sp']}: sequence "
                f"parallelism waits for {_SP}")
        if sizes.get("sharding", 1) > 1:
            raise NotImplementedError(
                f"pipeline with a sharding axis of {sizes['sharding']}: "
                f"optimizer slots sharded alongside the pipeline wait for "
                f"{_ZERO}")
        S = sizes.get("pp", 1)
        assert S > 1, ("the topology has no pp axis: use jit.TrainStep "
                       "(HybridParallelTrainStep waits for " + _TP + ")")
        self.num_stages = S
        self.stage = self.hcg.get_stage_id()
        self._t = 0
        (amp_enabled, amp_dtype, _recompute, _sharding,
         _accum) = _parse_strategy(strategy, sizes)
        self.amp_dtype = amp_dtype if amp_enabled else None
        self._fp16 = amp_enabled and amp_dtype == torch.float16
        if num_micro is None:
            num_micro = 1
            if strategy is not None and strategy.pipeline:
                num_micro = int(strategy.pipeline_configs.get(
                    "accumulate_steps", 1))
            num_micro = max(num_micro, S)
        self.num_micro = int(num_micro)

        if isinstance(model, PipelineLayer) and model.num_stages != S:
            raise ValueError(
                f"PipelineLayer was built for {model.num_stages} stages but "
                f"the topology's pp axis has {S}; make them agree")
        self._pre, blocks, prefixes, self._post = _gpt_like_parts(model)
        counts = None
        if isinstance(model, PipelineLayer):
            # the model's segmentation (uniform or "layer:X") restricted to
            # the scanned region; the edge layers take no stage slots
            start, stop = model.scan_region()
            bounds = model.segment()
            counts = [max(0, min(bounds[s + 1], stop) - max(bounds[s], start))
                      for s in range(S)]
            assert min(counts) >= 1, (
                f"seg_method={model.seg_method!r} gives stage block counts "
                f"{counts}; every stage needs >= 1 scanned layer")
        self.run = _BlockRun(blocks, prefixes, S, counts=counts)
        bufs = [k for k, _ in model.named_buffers()]
        if bufs:
            raise ValueError(f"pipelined models must be buffer-free: found "
                             f"buffers {bufs}. {_BN}")

        named = dict(model.named_parameters())
        block_full = {n for s in range(S) for n in self.run.stage_names(s)}
        self._edge_names = [k for k in named if k not in block_full]
        self._block_names = self.run.stage_names(self.stage)
        self._names = self._edge_names + self._block_names
        self._all_names = list(named)
        # every (module, slot) a parameter sits in, by its name
        name_of = {id(p): k for k, p in named.items()}
        self._slots: Dict[str, list] = collections.defaultdict(list)
        owners, seen = [], set()
        for mod in model.modules():
            for k, t in mod._parameters.items():
                if t is not None and id(t) in name_of:
                    n = name_of[id(t)]
                    self._slots[n].append((mod._parameters, k))
                    if n in self._edge_names and id(mod) not in seen:
                        seen.add(id(mod))
                        owners.append(mod)
        self._masters = {k: named[k].detach().clone().requires_grad_(True)
                         for k in self._names}
        self.device = named[self._names[0]].device
        self.opt_state = optimizer.init_state_tree(self._masters)
        if fused_opt is None:
            fused_opt = env_bool("PADDLE_TPU_FUSED_OPT", True)
        self.fused_opt = bool(fused_opt) and \
            optimizer.fused_update_supported
        self._lr = torch.zeros((), dtype=torch.float64, device=self.device)
        self._step_t = torch.zeros((), dtype=torch.float64,
                                   device=self.device)

        mine = self.run.stage_layers(self.stage)
        first, last = self.stage == 0, self.stage == S - 1

        def blocks_fn(x):
            for blk in mine:
                x = blk(x)
            return x

        if first:
            self._fwd = _Region(lambda *inp: blocks_fn(self._pre(model, *inp)),
                                owners + mine)
        else:
            self._fwd = _Region(blocks_fn, mine)
        self._head = (_Region(lambda h, y: self._loss_fn(
            self._post(model, h), y), owners) if last else None)

        self._pp = self.hcg.get_pipe_parallel_group()
        # the rows of a micro-batch split over dp (a sharding axis raised)
        self._dp = (self.hcg.get_data_parallel_group()
                    if _data_axes_of(sizes) else None)
        self._link = _Link(self._pp, self.device)
        # batch signature -> the incoming boundary's (shape, type); the
        # signatures whose outgoing boundary's header went out
        self._meta_in: dict = {}
        self._meta_out: set = set()
        sc = _scaler_config(strategy)
        self._sc = sc
        self.scaler_state = {"scale": sc["init_scale"] if self._fp16
                             else 1.0, "good": 0}
        self._health_probe, self._health_interval = _build_health_probe(
            {k: None for k in self._all_names}, health)
        self.last_health = None
        self.peak_in_flight = 0
        self.last_transfers = dict(count=0, bytes=0, seconds=0.0)
        # host seconds of the last step's parts: the schedule (forwards,
        # backwards, transfers), the reductions, the update
        self.last_times = dict(schedule=0.0, reduce=0.0, update=0.0)

    # -- data ---------------------------------------------------------------
    def shard_batch(self, *batch) -> List[torch.Tensor]:
        """Each global batch tensor as [M, rows, ...] on the step's device:
        M micro-batches of this rank's dp rows (micro-batch m is rows
        [m B/M, (m+1) B/M) of the global batch, split over dp)."""
        M = self.num_micro
        dp = self._dp.nranks if self._dp is not None else 1
        r = self._dp.rank if self._dp is not None else 0
        out = []
        for t in batch:
            t = torch.as_tensor(t)
            assert t.shape[0] % M == 0, (
                f"batch dim {t.shape[0]} not divisible by {M} micro-batches")
            mb = t.reshape((M, t.shape[0] // M) + tuple(t.shape[1:]))
            if mb.shape[1] % dp:
                raise ValueError(f"a micro-batch of {mb.shape[1]} rows does "
                                 f"not split over {dp} data-parallel ranks")
            k = mb.shape[1] // dp
            out.append(mb[:, r * k:(r + 1) * k].to(self.device))
        return out

    # -- the step -----------------------------------------------------------
    def _cast(self, t: torch.Tensor) -> torch.Tensor:
        if self.amp_dtype is not None and t.is_floating_point():
            return t.to(self.amp_dtype)
        return t

    def _signature(self, micro) -> tuple:
        return tuple((str(t.dtype), tuple(t.shape)) for t in micro)

    def __call__(self, *batch):
        self._t += 1
        arrs = self.shard_batch(*batch)
        inputs = [self._cast(a) for a in arrs[:-1]]
        labels = arrs[-1]
        sig = self._signature(arrs)
        M = self.num_micro
        self._lr.fill_(self.optimizer.get_lr())
        self._step_t.fill_(self._t)
        before = dict(self._link.stats)
        with torch.no_grad():
            if self.amp_dtype is not None:
                compute = {k: p.detach().to(self.amp_dtype).requires_grad_(
                    True) for k, p in self._masters.items()}
            else:
                for p in self._masters.values():
                    p.grad = None
                compute = self._masters
        mult = self.scaler_state["scale"] if self._fp16 else 1.0
        scope = (_parallel.loss_scope(self._dp, False)
                 if self._dp is not None else contextlib.nullcontext())
        t0 = time.perf_counter()
        with _health.suspended(), torch.enable_grad(), scope:
            total = self._schedule(compute, inputs, labels, sig, mult / M)
        t1 = time.perf_counter()
        grads = {k: (torch.zeros_like(p, dtype=torch.float32) if p.grad is None
                     else p.grad.float())
                 for k, p in compute.items()}
        if self.amp_dtype is None:
            for p in self._masters.values():
                p.grad = None
        del compute
        loss = self._reduce(grads, total)
        t2 = time.perf_counter()
        self._update(grads, loss)
        self.last_times = dict(schedule=t1 - t0, reduce=t2 - t1,
                               update=time.perf_counter() - t2)
        self.last_transfers = {k: self._link.stats[k] - before[k]
                               for k in before}
        return loss

    def _schedule(self, compute, inputs, labels, sig, seed_scale):
        """The 1F1B schedule of this stage (Megatron-LM's non-interleaved
        order); returns the sum of its micro-batch losses (stage S-1) or
        None."""
        M, S, s = self.num_micro, self.num_stages, self.stage
        first, last = s == 0, s == S - 1
        swap_slots = [sl for k in self._names for sl in self._slots[k]]
        swap_vals = [compute[k] for k in self._names
                     for _ in self._slots[k]]
        ctxs = collections.deque()
        state = dict(fwd=0, in_flight=0, peak=0, total=None)
        meta = self._meta_in.get(sig)

        def recv_forward():
            nonlocal meta
            if first:
                return None
            if meta is None:  # the boundary's shape and type, once
                head, = self._link.exchange([], [((8,), torch.int64, s - 1)])
                n = int(head[0])
                meta = self._meta_in[sig] = (tuple(int(d) for d in
                                                head[1:1 + n]),
                                          _DTYPES[int(head[7])])
            x, = self._link.exchange([], [(meta[0], meta[1], s - 1)])
            return x

        def send_forward(y):
            if last:
                return
            if sig not in self._meta_out:
                head = torch.zeros(8, dtype=torch.int64)
                head[0] = y.dim()
                head[1:1 + y.dim()] = torch.tensor(y.shape)
                head[7] = _DTYPES.index(y.dtype)
                self._link.exchange([(head.to(self.device), s + 1)], [])
                self._meta_out.add(sig)
            self._link.exchange([(y, s + 1)], [])

        def fwd(x):
            m = state["fwd"]
            state["fwd"] += 1
            with _swapped(swap_slots, swap_vals):
                if first:
                    y = recompute(self._fwd, *[t[m] for t in inputs])
                else:
                    x = x.requires_grad_(True)
                    y = recompute(self._fwd, x)
                if last:
                    y = recompute(self._head, y, labels[m])
                    t = y.detach().float()
                    state["total"] = t if state["total"] is None \
                        else state["total"] + t
            ctxs.append((x, y))
            state["in_flight"] += 1
            state["peak"] = max(state["peak"], state["in_flight"])
            return None if last else y

        def bwd(dy):
            x, y = ctxs.popleft()
            if last:
                (y.float() * seed_scale).backward()
            else:
                torch.autograd.backward(y, dy)
            state["in_flight"] -= 1
            if first:
                return None
            return x.grad if x.grad is not None else torch.zeros_like(x)

        def send_forward_recv_backward(y):
            if last:
                return None
            dy, = self._link.exchange([(y, s + 1)],
                                      [(y.shape, y.dtype, s + 1)])
            return dy

        def send_backward_recv_forward(dx):
            if first:
                return None
            x, = self._link.exchange([(dx, s - 1)],
                                     [(meta[0], meta[1], s - 1)])
            return x

        def recv_backward(shape, dtype):
            if last:
                return None
            dy, = self._link.exchange([], [(shape, dtype, s + 1)])
            return dy

        def send_backward(dx):
            if not first:
                self._link.exchange([(dx, s - 1)], [])

        warm = min(S - s - 1, M)
        rem = M - warm
        for _ in range(warm):
            send_forward(fwd(recv_forward()))
        x = recv_forward() if rem > 0 else None
        for i in range(rem):
            y = fwd(x)
            dy = send_forward_recv_backward(y)
            dx = bwd(dy)
            if i == rem - 1:
                send_backward(dx)
            else:
                x = send_backward_recv_forward(dx)
        for _ in range(warm):
            y = ctxs[0][1]
            dx = bwd(recv_backward(y.shape, y.dtype))
            send_backward(dx)
        self.peak_in_flight = state["peak"]
        return state["total"]

    @torch.no_grad()
    def _reduce(self, grads: dict, total) -> torch.Tensor:
        """Block gradients averaged over dp, edge gradients summed over pp
        and averaged over dp (each set through one flat buffer); the
        loss, the mean of the micro-batch losses over dp, broadcast from
        stage S-1 over pp."""
        def flat_reduce(names, g, kind, div):
            if not names:
                return
            flat = torch.cat([grads[k].reshape(-1) for k in names])
            C.raw_all_reduce(flat, g, kind=kind)
            if div > 1:
                flat.div_(div)
            off = 0
            for k in names:
                n = grads[k].numel()
                grads[k] = flat[off:off + n].view_as(grads[k])
                off += n

        dp = self._dp.nranks if self._dp is not None else 1
        flat_reduce(self._edge_names, self._pp, "pp_edge_grads", 1)
        if self._dp is not None:
            flat_reduce(self._names, self._dp, "all_reduce", dp)
        if total is None:
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
        else:
            loss = total / self.num_micro
            if self._dp is not None:
                C.raw_all_reduce(loss, self._dp)
                loss = loss / dp
        _bcast(loss, self._pp, self.num_stages - 1, "pp_loss")
        return loss

    def _update(self, grads: dict, loss: torch.Tensor) -> None:
        fetch = (self._health_probe is not None
                 and self._t % self._health_interval == 0)
        old = hgrads = None
        if fetch:
            old = {k: v.detach().clone() for k, v in self._masters.items()}
            hgrads = _health_grads(grads, self.scaler_state, self._fp16)
        kw = dict(fused=self.fused_opt)
        if self._fp16:
            world = C._get_default_group()

            def finite_all(flag):
                C.raw_all_reduce(flag, world, op=C.ReduceOp.MIN,
                                 kind="pp_finite")
                return flag
            _apply_scaled_update(self.optimizer, self._masters, grads,
                                 self.opt_state, self._lr, self._step_t,
                                 self.scaler_state, self._sc,
                                 finite_all=finite_all, **kw)
        else:
            self.optimizer.apply_fn(self._masters, grads, self.opt_state,
                                    lr=self._lr, t=self._step_t,
                                    inplace=True, **kw)
        if fetch:
            _note_health(self, self._sentinel(loss, hgrads, old))

    def _sentinel(self, loss, grads, old) -> torch.Tensor:
        """The reference's sentinel vector over the whole model: this
        rank's squared norms in the slots of every name of the model (the
        other stages' blocks as zeros), the edge parameters counted on
        stage 0 alone, all-reduced over pp."""
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        own = set(self._block_names) | (set(self._edge_names)
                                        if self.stage == 0 else set())
        full = {k: (grads[k] if k in grads else zero)
                for k in self._all_names}
        before = {k: (old[k] if k in old else zero) for k in self._all_names}
        after = {k: (self._masters[k] if k in self._masters else zero)
                 for k in self._all_names}
        mask = None

        def reduce(names, sq, bad):
            nonlocal mask
            if mask is None:
                mask = torch.tensor([n in own for n in names],
                                    dtype=sq.dtype, device=sq.device)
            sq = sq * mask
            flags = bad.to(sq.dtype) * mask
            C.raw_all_reduce(sq, self._pp, kind="health")
            C.raw_all_reduce(flags, self._pp, kind="health")
            return sq, flags > 0

        return self._health_probe.stats_vec(loss, full, before, after,
                                            reduce=reduce)

    # -- the parameters -----------------------------------------------------
    @property
    def params(self) -> dict:
        """{"edge": {name: master}, "blocks": {name: master}}: this rank's
        fp32 masters, its own stage's blocks under their names in the
        model (the reference stacks every stage's blocks instead)."""
        return {"edge": {k: self._masters[k] for k in self._edge_names},
                "blocks": {k: self._masters[k] for k in self._block_names}}

    @params.setter
    def params(self, tree: dict) -> None:
        with torch.no_grad():
            for part in tree.values():
                for k, v in part.items():
                    self._masters[k].copy_(v)

    @torch.no_grad()
    def sync_to_layer(self) -> None:
        """Write the trained values into the model, whole on every rank:
        the edge masters as they are, each stage's blocks broadcast from
        their owner over the pp group (one flat buffer a stage)."""
        named = dict(self.layer.named_parameters())
        for k in self._edge_names:
            named[k].copy_(self._masters[k])
        for s in range(self.num_stages):
            names = self.run.stage_names(s)
            ts = [named[k] for k in names]
            if s == self.stage:
                flat = torch.cat([self._masters[k].reshape(-1)
                                  for k in names])
            else:
                flat = torch.empty(sum(t.numel() for t in ts),
                                   dtype=ts[0].dtype, device=self.device)
            _bcast(flat, self._pp, s, "pp_sync")
            off = 0
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()


class PipelineParallel(torch.nn.Module):
    """PaddlePaddle's wrapper (``meta_parallel/pipeline_parallel.py:30``):
    ``model = PipelineParallel(pipeline_layer, hcg, strategy)``, then
    ``loss = model.train_batch([data, labels], optimizer, lr_scheduler)``
    on every rank with the global batch."""

    def __init__(self, layers, hcg=None, strategy=None, **kw):
        super().__init__()
        self._layers = layers
        self._hcg = hcg or get_hybrid_communicate_group()
        self._strategy = strategy
        self._train_step = None

    def forward(self, *args, **kw):
        return self._layers(*args, **kw)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One step of the global batch ``data`` ([inputs..., labels]).
        fp16 loss scaling runs inside the step when the strategy asks for
        amp dtype "float16", so a ``scaler`` is left as it is."""
        if (self._train_step is not None
                and self._train_step.optimizer is not optimizer):
            raise ValueError(
                "train_batch was built against a different optimizer; "
                "build a new PipelineParallel to swap optimizers")
        if self._train_step is None:
            loss_fn = getattr(self._layers, "_loss_fn", None)
            if loss_fn is None:
                from ...nn import functional as F
                loss_fn = F.cross_entropy
            self._train_step = PipelineParallelTrainStep(
                self._layers, loss_fn, optimizer, hcg=self._hcg,
                strategy=self._strategy)
        inputs = data if isinstance(data, (list, tuple)) else [data]
        loss = self._train_step(*inputs)
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss
