"""Whole-step training (counterpart of ``paddle_tpu/jit/__init__.py``:
``functionalize`` l.73 and ``TrainStep`` l.346).

The reference traces forward, backward and optimizer update into one XLA
executable. PyTorch runs eagerly, so here one step is: cast the fp32
master parameters to the compute type once, run the layer on those casts
through ``torch.func.functional_call``, take the loss and its gradients
with autograd, and update the masters in place with the optimizer's
``apply_fn`` (the counterpart of buffer donation). The kernels of the
path are launched by the autograd Functions of ``ops/kernels``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call


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

    The update is always in place (the reference's ``donate=True``).
    ``sync_to_layer()`` writes the masters back into ``layer``.
    """

    def __init__(self, layer: torch.nn.Module, loss_fn, optimizer,
                 amp_dtype=None, health=None, fused_opt=None):
        if health:
            raise NotImplementedError(
                "TrainStep(health=...): the in-step numerics sentinel is not "
                "ported yet (ROADMAP A10)")
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

    def _cast(self, t):
        if self.amp_dtype is not None and t.is_floating_point():
            return t.to(self.amp_dtype)
        return t

    def __call__(self, *batch):
        self._t += 1
        lr = self.optimizer.get_lr()
        inputs = tuple(self._cast(a) for a in batch[:-1])
        names = list(self.params)
        with torch.enable_grad():
            compute = {k: self._cast(p) for k, p in self.params.items()}
            out, self.buffers = self.apply_fn(compute, self.buffers, *inputs)
            loss = self._loss_fn(out, batch[-1])
            grads = torch.autograd.grad(
                loss, [self.params[k] for k in names])
        self.optimizer.apply_fn(self.params, dict(zip(names, grads)),
                                self.opt_state, lr=lr, t=self._t,
                                fused=self.fused_opt)
        return loss.detach()

    def _leaves(self):
        """(name, slot) pairs in the reference's pytree order: sorted
        parameter names, then sorted slot names."""
        return [(n, s) for n in sorted(self.opt_state)
                for s in sorted(self.opt_state[n])]

    def state_dict(self) -> dict:
        """{"t", "opt_flat"}: the step count and the optimizer slots as
        numpy arrays in the reference's leaf order, so that a checkpoint of
        either package loads in the other."""
        return {"t": self._t,
                "opt_flat": [self.opt_state[n][s].detach().cpu().numpy()
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
            v = torch.tensor(np.asarray(v), dtype=cur.dtype,
                             device=cur.device)
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
