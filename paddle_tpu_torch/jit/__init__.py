"""Whole-step training (counterpart of ``paddle_tpu/jit/__init__.py``:
``functionalize`` l.73 and ``TrainStep`` l.346).

The reference traces forward, backward and optimizer update into one XLA
executable. PyTorch runs eagerly, so here one step is: cast the fp32
master parameters to the compute type once, run the layer on those casts
through ``torch.func.functional_call``, take the loss and its gradients
with autograd, and form new masters with the optimizer's ``apply_fn``
(the reference's functional update). The kernels of the path are
launched by the autograd Functions of ``ops/kernels``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from ..framework.io import to_host
from ..profiler import health as _health


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
    per-parameter loop; on (None or True) unless False, and only for
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
    parameter); a pending vector holds those parameters until it is
    decoded.

    The update is out of place (the reference's functional form): each
    step binds new master tensors, so the norm of the update is
    ``||new - old||`` as in the reference. ``sync_to_layer()`` writes the
    masters back into ``layer``.
    """

    def __init__(self, layer: torch.nn.Module, loss_fn, optimizer,
                 donate: bool = True, amp_dtype=None, health=None,
                 fused_opt=None):
        self.layer = layer
        self.optimizer = optimizer
        self.amp_dtype = amp_dtype
        self._loss_fn = loss_fn
        self.apply_fn, params, buffers = functionalize(layer)
        self.params = {k: p.detach().clone().requires_grad_(True)
                       for k, p in params.items()}
        self.buffers = {k: b.detach().clone() for k, b in buffers.items()}
        self.opt_state = optimizer.init_state_tree(self.params)
        self._t = 0
        self.fused_opt = (fused_opt is not False
                          and optimizer.fused_update_supported)
        if health is None:
            health = _health.enabled()
        self._health_probe = _health.HealthProbe(self.params) if health \
            else None
        self._health_interval = _health.interval()
        self._last_batch = None   # kept only while health is on
        self._nan_replayed = False
        self._health_host = None  # pinned buffer the vector is fetched into
        # (step, host vector, copy's event, incoming params, batch) of the
        # newest fetch not decoded yet
        self._pending = None
        self._last_health = None  # newest decoded sentinel stats
        self._last_attribution = None

    def _cast(self, t):
        if self.amp_dtype is not None and t.is_floating_point():
            return t.to(self.amp_dtype)
        return t

    def __call__(self, *batch):
        self._t += 1
        pending = self._pending
        if pending is not None and (pending[2] is None or pending[2].query()):
            self.flush_health()  # landed: decode it and let its params go
        lr = self.optimizer.get_lr()
        inputs = tuple(self._cast(a) for a in batch[:-1])
        names = list(self.params)
        probe = self._health_probe
        fetch = probe is not None and self._t % self._health_interval == 0
        # the per-op NaN check never looks inside a step (the reference's
        # compiled step is out of its reach too): the sentinel covers it
        with _health.suspended():
            with torch.enable_grad():
                compute = {k: self._cast(p) for k, p in self.params.items()}
                out, self.buffers = self.apply_fn(compute, self.buffers,
                                                  *inputs)
                loss = self._loss_fn(out, batch[-1])
                grads = torch.autograd.grad(
                    loss, [self.params[k] for k in names], allow_unused=True)
            # a parameter the loss does not reach (ERNIE's pooler under the
            # MLM loss) gets a zero gradient, as jax.grad gives it
            grads = dict(zip(names, (
                torch.zeros_like(self.params[k]) if g is None else g
                for k, g in zip(names, grads))))
            old = self.params
            new = self.optimizer.apply_fn(
                old, grads, self.opt_state, lr=lr, t=self._t,
                fused=self.fused_opt, inplace=False)[0]
            self.params = {k: v.requires_grad_(True) for k, v in new.items()}
            hvec = probe.stats_vec(loss, grads, old, new) if fetch else None
        if probe is not None:
            self._last_batch = batch
            if fetch:
                self._fetch(hvec, old)
        return loss.detach()

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
        leaves = self._leaves()
        saved = sd["opt_flat"]
        if len(saved) != len(leaves):
            raise ValueError(f"opt state mismatch: checkpoint has "
                             f"{len(saved)} leaves, model needs "
                             f"{len(leaves)}")
        for (n, s), v in zip(leaves, saved):
            cur = self.opt_state[n][s]
            v = (v if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.array(v))).to(
                     dtype=cur.dtype, device=cur.device, copy=True)
            if v.shape != cur.shape:
                raise ValueError(f"opt state {n}.{s}: checkpoint "
                                 f"{tuple(v.shape)}, model {tuple(cur.shape)}")
            self.opt_state[n][s] = v
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


__all__ = ["functionalize", "TrainStep"]
