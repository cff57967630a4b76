"""Whole-step training (counterpart of ``paddle_tpu/jit/__init__.py``:
``functionalize`` l.73 and ``TrainStep`` l.346).

The reference traces forward, backward and optimizer update into one XLA
executable per batch signature. Here one step is: cast the fp32 master
parameters to the compute type once, run the layer on those casts
through ``torch.func.functional_call``, take the loss and its gradients
with autograd, and update the masters and the optimizer's slots in place
with the optimizer's ``apply_fn`` (the reference's functional update).
The kernels of the path are launched by the autograd Functions of
``ops/kernels``. On a card that step is captured into one CUDA graph per
batch signature (``jit.graphs.StepGraphs``), which every later call with
that signature replays; on the CPU the same step runs uncaptured.

Over a ``distributed.DataParallel`` the step is the reference's step on
a ``dp`` mesh: each rank feeds its rows of the global batch, and between
the gradients and the update the step copies the gradients into flat
static buckets, all-reduces them over the group and divides by its size
(inside the captured graph on a card, over nccl), and returns the
group's mean loss: the loss of the global batch. Its batch norms take the
group's statistics (``distributed.parallel.bn_scope``), their all-reduces
in the same graph.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.func import functional_call

from ..distributed import collective as _collective
from ..distributed import parallel as _parallel
from ..framework.io import to_host
from ..profiler import compile_watch as _compile_watch
from ..profiler import health as _health
from ..profiler.watchdog import get_watchdog as _get_watchdog
from ..utils.envparse import env_bool
from .graphs import StepGraphs


def functionalize(layer: torch.nn.Module):
    """(apply_fn, params, buffers): ``apply_fn(params, buffers, *inputs,
    **kw) -> (outputs, new_buffers)`` runs ``layer`` with the given
    {name: tensor} dicts in place of its own parameters and buffers.
    Buffers updated in place by the forward come back as ``new_buffers``.
    (The reference also threads an RNG key; dropout here draws from
    PyTorch's generators, which ``paddle_tpu_torch.seed`` seeds.)"""
    params0 = dict(layer.named_parameters())
    buffers0 = dict(layer.named_buffers())

    def apply_fn(params, buffers, *inputs, **kw):
        out = functional_call(layer, {**params, **buffers}, inputs, kw)
        return out, buffers

    return apply_fn, params0, buffers0


def _signature(batch) -> tuple:
    """A batch's signature, the key of its graph: the type, shape and
    device of each tensor, and the value of anything else (its ``repr``
    when it cannot be hashed)."""
    sig = []
    for a in batch:
        if isinstance(a, torch.Tensor):
            sig.append((str(a.dtype).replace("torch.", ""), tuple(a.shape),
                        str(a.device)))
        else:
            try:
                hash(a)
                sig.append(("value", a))
            except TypeError:
                sig.append(("value", repr(a)))
    return tuple(sig)


def _require_capturable(group, device) -> None:
    """A step on a card is captured, and a capture can hold only an nccl
    collective: raise for any other backend there."""
    if device.type == "cuda" and group.backend != "nccl":
        raise RuntimeError(
            f"TrainStep over DataParallel on {device}: the group's backend "
            f"is {group.backend!r}, and a captured step cannot hold a "
            f"{group.backend} collective; use nccl (one card a rank), or "
            f"the eager DataParallel loop (loss.backward(); opt.step())")


class TrainStep:
    """One training step of ``layer`` under ``loss_fn`` and ``optimizer``
    per call: ``loss = step(*inputs, labels)``.

    donate: taken in the reference's slot and not used: the reference
    donates its state buffers to the compiled step, and no result depends
    on it.

    amp_dtype: e.g. ``torch.bfloat16`` for O2 mixed precision. The step
    holds fp32 master copies of the parameters and the optimizer's fp32
    slots privately; each floating parameter is cast to ``amp_dtype`` ONCE
    per step (so the tied embedding gets one bf16 copy, whose two uses sum
    their gradients in bf16 before the cast back to fp32), and floating
    inputs are cast too (labels, the last input, pass through). bf16 needs
    no loss scaling.

    fused_opt: run the update as grouped multi-tensor applies
    (``Optimizer.apply_fn(fused=True)``), equal element for element to the
    per-parameter loop. None (the default) follows
    ``PADDLE_TPU_FUSED_OPT`` (on unless it is 0); either way only for
    elementwise optimizers.

    health: fold the step sentinel (``profiler/health.py``
    ``HealthProbe``) into the step: every ``PADDLE_TPU_HEALTH_INTERVAL``
    steps the loss, a nonfinite flag, the gradient, update and parameter
    norms and per-layer-group gradient norms are reduced on the device
    and copied, without a wait, into a pinned host buffer as one small
    vector. It is decoded at the start of a later step if its copy has
    landed, before the next vector is copied at the latest, and whenever
    ``last_health`` or ``last_attribution`` is read (``flush_health()``),
    so the host can queue a step ahead of the device. None (the default)
    follows ``PADDLE_TPU_HEALTH=1`` and ``FLAGS_check_nan_inf``. A trip
    replays its step's batch once with the per-op NaN check armed
    (``last_attribution``), on the parameters that step took in (the
    reference replays after its update, when a NaN has reached every
    parameter): a fetched step first copies the incoming masters into a
    snapshot, one of two used in turn, which the pending vector holds
    until it is decoded.

    The update is in place: the masters (``params``), the optimizer's
    slots (``opt_state``) and the buffers keep their tensors for the
    step's life, and ``lr`` and the step count reach the update as 0-d
    fp64 tensors on the device, filled before each step (``lr`` from
    ``optimizer.get_lr()``, so a scheduler stepped between calls takes
    effect). The update's norm ``||new - old||`` is taken against the
    snapshot. Write into the masters in place (``step.params[k].copy_``):
    a captured step reads the tensors it captured, not one bound in their
    place. ``sync_to_layer()`` writes the masters back into ``layer``.

    On a card each batch signature (``_signature``) is captured into a
    CUDA graph on its first use, a fetched step (health) in a variant of
    its own for each snapshot; every later call copies the batch into the
    signature's static inputs, replays, and returns a fresh copy of the
    loss. A step that cannot be captured (a ``loss_fn`` that reads a
    value back with ``.item()``) raises; nothing falls back to running
    uncaptured. ``stats`` counts captures, replays and the pool's bytes.
    On the CPU the same step runs uncaptured.

    ``layer`` a ``DataParallel``: the step runs its inner layer (the
    parameters under their own names) and reduces the gradients over its
    group, in buckets of its ``comm_buffer_size`` MB, while
    ``F.cross_entropy`` divides by the group's label count; the returned
    loss is the group's mean. On a card the group must be nccl's (a
    captured step cannot hold a gloo collective: it raises); its
    communicator is used once before the first capture, and checked after
    a capture that failed.
    """

    _seq = 0

    def __init__(self, layer: torch.nn.Module, loss_fn, optimizer,
                 donate: bool = True, amp_dtype=None, health=None,
                 fused_opt=None):
        TrainStep._seq += 1
        # the retrace watchdog's and compile attribution's name
        self._wd_name = f"{type(layer).__name__}#{TrainStep._seq}"
        self.layer = layer
        self.optimizer = optimizer
        self.amp_dtype = amp_dtype
        self._loss_fn = loss_fn
        dp = layer if isinstance(layer, _parallel.DataParallel) else None
        self._group = dp._group if dp is not None else None
        self.apply_fn, params, buffers = functionalize(
            dp._layers if dp is not None else layer)
        self.params = {k: p.detach().clone().requires_grad_(True)
                       for k, p in params.items()}
        self.buffers = {k: b.detach().clone() for k, b in buffers.items()}
        self.opt_state = optimizer.init_state_tree(self.params)
        self._names = list(self.params)
        self._t = 0
        if fused_opt is None:
            fused_opt = env_bool("PADDLE_TPU_FUSED_OPT", True)
        self.fused_opt = (bool(fused_opt)
                          and optimizer.fused_update_supported)
        self.device = (next(iter(self.params.values())).device
                       if self.params else torch.device("cpu"))
        # the update's scalars, filled before every step
        self._lr = torch.zeros((), dtype=torch.float64, device=self.device)
        self._step_t = torch.zeros((), dtype=torch.float64,
                                   device=self.device)
        self._buckets = []
        if self._group is not None:
            _require_capturable(self._group, self.device)
            self._buckets = self._make_buckets(dp.comm_buffer_size)
            if self.device.type == "cuda":
                self._check_group()  # the communicator exists before capture
        self._graphs = (StepGraphs(
            self.device, "TrainStep",
            on_recover=self._check_group if self._group else None)
            if self.device.type == "cuda" else None)
        self._static: dict = {}   # signature -> the batch's static tensors
        if health is None:
            health = _health.enabled()
        self._health_probe = _health.HealthProbe(self.params) if health \
            else None
        self._health_interval = _health.interval()
        self._snapshots = [None, None]  # incoming masters of fetched steps
        self._fetches = 0
        self._last_batch = None   # kept only while health is on
        self._nan_replayed = False
        self._health_host = None  # pinned buffer the vector is fetched into
        # (step, host vector, copy's event, incoming params, batch) of the
        # newest fetch not decoded yet
        self._pending = None
        self._last_health = None  # newest decoded sentinel stats
        self._last_attribution = None

    def _make_buckets(self, mb):
        """[(flat, names, views)]: static fp32 buffers (one type a
        bucket) of at most ``mb`` MB, a view in each for every master."""
        cap = float(mb) * 2 ** 20
        groups, cur, size = [], [], 0
        for k in self._names:
            p = self.params[k]
            nb = p.numel() * p.element_size()
            if cur and (size + nb > cap
                        or p.dtype != self.params[cur[0]].dtype):
                groups.append(cur)
                cur, size = [], 0
            cur.append(k)
            size += nb
        if cur:
            groups.append(cur)
        out = []
        for names in groups:
            ps = [self.params[k] for k in names]
            flat = torch.empty(sum(p.numel() for p in ps),
                               dtype=ps[0].dtype, device=self.device)
            views, off = [], 0
            for p in ps:
                views.append(flat[off:off + p.numel()].view(p.shape))
                off += p.numel()
            out.append((flat, names, views))
        return out

    def _check_group(self) -> None:
        """One all-reduce over the group, waited for: before the first
        capture it brings the communicator up; after a failed capture it
        shows the group still answers."""
        one = torch.ones(1, device=self.device)
        _collective.raw_all_reduce(one, self._group)
        if float(one) != self._group.nranks:
            raise RuntimeError(f"TrainStep: an all-reduce over "
                               f"{self._group!r} gave {float(one)}")

    def _reduce(self, grads: dict, loss: torch.Tensor):
        """The group's mean of the gradients (through the buckets, whose
        views become the gradients) and of the loss."""
        g = self._group
        for flat, names, views in self._buckets:
            torch._foreach_copy_(views, [grads[k] for k in names])
            _collective.raw_all_reduce(flat, g)
            flat.div_(g.nranks)
            grads.update(zip(names, views))
        loss = loss.detach().clone()
        _collective.raw_all_reduce(loss, g)
        return grads, loss.div_(g.nranks)

    def _cast(self, t):
        if self.amp_dtype is not None and t.is_floating_point():
            return t.to(self.amp_dtype)
        return t

    def _step_fn(self, batch, snapshot):
        """The step: forward, backward and the in-place update; the
        sentinel's vector too when ``snapshot`` (a dict of tensors like
        the masters) is given, into which the incoming masters are first
        copied. Returns (loss, vector or None). It reads the masters,
        slots, buffers, ``_lr`` and ``_step_t`` and writes them in place,
        and waits on nothing, so it can be captured. The per-op NaN check
        never looks inside it (the reference's compiled step is out of its
        reach too): the sentinel covers it."""
        names = self._names
        inputs = tuple(self._cast(a) for a in batch[:-1])
        with _health.suspended():
            if snapshot is not None:
                with torch.no_grad():
                    torch._foreach_copy_([snapshot[k] for k in names],
                                         [self.params[k] for k in names])
            scope = contextlib.ExitStack()
            if self._group is not None:
                # the global batch's loss and batch statistics
                scope.enter_context(_parallel.loss_scope(self._group, False))
                scope.enter_context(_parallel.bn_scope(self._group))
            with torch.enable_grad(), scope:
                compute = {k: self._cast(p) for k, p in self.params.items()}
                out, _ = self.apply_fn(compute, self.buffers, *inputs)
                loss = self._loss_fn(out, batch[-1])
                grads = torch.autograd.grad(
                    loss, [self.params[k] for k in names], allow_unused=True)
            # a parameter the loss does not reach (ERNIE's pooler under the
            # MLM loss) gets a zero gradient, as jax.grad gives it
            grads = dict(zip(names, (
                torch.zeros_like(self.params[k]) if g is None else g
                for k, g in zip(names, grads))))
            if self._group is not None:
                grads, loss = self._reduce(grads, loss)
            self.optimizer.apply_fn(
                self.params, grads, self.opt_state, lr=self._lr,
                t=self._step_t, fused=self.fused_opt, inplace=True)
            hvec = None
            if snapshot is not None:
                hvec = self._health_probe.stats_vec(loss, grads, snapshot,
                                                    self.params)
        return loss.detach(), hvec

    def __call__(self, *batch):
        # a new batch signature captures the WHOLE step anew — the most
        # expensive recapture in the system; always worth an event
        _get_watchdog().observe("train_step", self._wd_name, batch)
        prev = _compile_watch.push_entry("train_step", self._wd_name)
        try:
            return self._run(batch, self._graphs is not None)
        finally:
            _compile_watch.pop_entry(prev)

    def _step_uncaptured(self, *batch):
        """The same step without a graph, on a card as on the CPU: the
        captured step's A/B (``chip_smoke.py``'s capture gate and the
        profiling tools) and nothing else."""
        return self._run(batch, False)

    def _run(self, batch, captured: bool):
        self._t += 1
        pending = self._pending
        if pending is not None and (pending[2] is None or pending[2].query()):
            self.flush_health()  # landed: decode it and let its params go
        fetch = (self._health_probe is not None
                 and self._t % self._health_interval == 0)
        slot = snapshot = None
        if fetch:
            slot = self._fetches % 2
            self._fetches += 1
            if self._snapshots[slot] is None:
                self._snapshots[slot] = {
                    k: torch.empty_like(p, requires_grad=False)
                    for k, p in self.params.items()}
            snapshot = self._snapshots[slot]
        self._lr.fill_(self.optimizer.get_lr())
        self._step_t.fill_(self._t)
        if captured:
            sig = _signature(batch)
            static = self._static.get(sig)
            if static is None:
                static = self._static[sig] = tuple(
                    torch.empty_like(a) if isinstance(a, torch.Tensor)
                    else a for a in batch)
            for s, a in zip(static, batch):
                if isinstance(a, torch.Tensor):
                    s.copy_(a)
            key = (sig, "step" if slot is None else f"fetch:{slot}")
            fresh = key not in self._graphs.graphs
            loss, hvec = self._graphs.run(
                key, lambda: self._step_fn(static, snapshot))
            if not fresh:
                loss = loss.clone()
        else:
            loss, hvec = self._step_fn(batch, snapshot)
        if self._health_probe is not None:
            self._last_batch = batch
            if fetch:
                self._fetch(hvec, snapshot)
        return loss

    @property
    def stats(self) -> dict:
        """{"graph_captures", "graph_replays" ({(signature, variant):
        replays}), "graph_pool_bytes"}; zeros on the CPU."""
        g = self._graphs
        return {"graph_captures": g.captures if g else 0,
                "graph_replays": dict(g.replays) if g else {},
                "graph_pool_bytes": g.pool_bytes if g else 0}

    def release_graphs(self) -> None:
        """Drop the captured graphs and their static inputs; the next call
        of each signature captures it again."""
        if self._graphs is not None:
            self._graphs.clear()
        self._static.clear()

    def _fetch(self, hvec: torch.Tensor, old: dict) -> None:
        """The tier's one device->host transfer: the vector into a pinned
        buffer, with no wait; it is decoded by ``flush_health``. The
        previous vector is decoded first: it shares the buffer, and by now
        this step's work is queued behind it."""
        self.flush_health()
        event = None
        if hvec.is_cuda:
            buf = self._health_host
            if buf is None or buf.shape != hvec.shape:
                buf = self._health_host = torch.empty(
                    hvec.shape, dtype=hvec.dtype, pin_memory=True)
            buf.copy_(hvec, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(hvec.device))
            hvec = buf
        self._pending = (self._t, hvec, event, old, self._last_batch)

    def flush_health(self) -> None:
        """Decode the pending sentinel vector, if any (waiting for its
        copy): record it, and on a fresh trip replay its step's batch once
        with the per-op check armed, on that step's incoming parameters.
        Never raises."""
        pending, self._pending = self._pending, None
        if pending is None:
            return
        t, host, event, old, batch = pending
        try:
            if event is not None:
                event.synchronize()
            stats = self._health_probe.decode(host.numpy())
            self._last_health = _health.record_step_stats(
                stats, step=t, source="sentinel")
        except Exception:
            return
        if not stats.get("nonfinite"):
            self._nan_replayed = False
            return
        if self._nan_replayed:
            return
        self._nan_replayed = True  # one replay per trip, not per step
        try:
            self._last_attribution = _health.eager_replay(
                self.layer, self._loss_fn, batch,
                state={**old, **self.buffers})
        except Exception:
            pass

    @property
    def last_health(self):
        """The newest decoded sentinel stats (decodes a pending vector)."""
        self.flush_health()
        return self._last_health

    @property
    def last_attribution(self):
        """The newest trip replay's first bad op and layer path (decodes a
        pending vector)."""
        self.flush_health()
        return self._last_attribution

    def _leaves(self):
        """(name, slot) pairs in the reference's pytree order: sorted
        parameter names, then sorted slot names."""
        return [(n, s) for n in sorted(self.opt_state)
                for s in sorted(self.opt_state[n])]

    def state_dict(self) -> dict:
        """{"t", "opt_flat"}: the step count and the optimizer slots as
        numpy arrays (bf16 ones as CPU tensors: numpy has none) in the
        reference's leaf order, so that a checkpoint of either package
        loads in the other."""
        return {"t": self._t,
                "opt_flat": [to_host(self.opt_state[n][s])
                             for n, s in self._leaves()]}

    def set_state_dict(self, sd: dict) -> None:
        """Load ``state_dict()``'s form: the slots are copied into the
        step's own tensors, so a captured step reads them."""
        leaves = self._leaves()
        saved = sd["opt_flat"]
        if len(saved) != len(leaves):
            raise ValueError(f"opt state mismatch: checkpoint has "
                             f"{len(saved)} leaves, model needs "
                             f"{len(leaves)}")
        loaded = []
        for (n, s), v in zip(leaves, saved):
            cur = self.opt_state[n][s]
            v = (v if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.array(v)))
            if tuple(v.shape) != tuple(cur.shape):
                raise ValueError(f"opt state {n}.{s}: checkpoint "
                                 f"{tuple(v.shape)}, model {tuple(cur.shape)}")
            loaded.append((cur, v))
        with torch.no_grad():
            for cur, v in loaded:
                cur.copy_(v)
        self._t = int(sd["t"])

    @torch.no_grad()
    def sync_to_layer(self) -> None:
        """Write the step's parameters and buffers back into the layer."""
        named = dict(self.layer.named_parameters())
        for k, v in self.params.items():
            named[k].copy_(v)
        named_b = dict(self.layer.named_buffers())
        for k, v in self.buffers.items():
            if k in named_b:
                named_b[k].copy_(v)


__all__ = ["functionalize", "TrainStep", "StepGraphs"]
