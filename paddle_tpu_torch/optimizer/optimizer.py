"""Optimizer base (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

Each optimizer defines one update ``_update(p, g, slots, lr, t)``,
written with ordinary arithmetic operators on ``TensorGroup``s: a list of
tensors whose every operator is one ``torch._foreach_*`` call. The eager
``step()`` and ``apply_fn(fused=False)`` run it once per parameter (a
group of one); ``apply_fn(fused=True)`` runs it once per group of
parameters that share a type, options and slot layout, which is the
reference's grouped multi-tensor update (its ``merged_adam`` form).
Both paths launch the same elementwise functors on every element, so the
grouped update equals the per-parameter loop element for element.

Updates are in place: parameters and slots are overwritten with
``copy_`` (the counterpart of the reference's buffer donation), so that
every tensor that outlives a step keeps its address, as a captured CUDA
graph needs. ``apply_fn`` (the compiled step's update) takes ``lr`` and
``t`` as 0-d fp64 tensors on the parameters' device, as the reference's
jitted step takes them as device values: a captured step reads the
values filled in before each replay. The scalar arithmetic (bias
corrections, ``1 - lr * wd``) runs on those in fp64 and each result is
rounded to fp32 where it meets the tensors, which is what the eager
``step()`` does with Python floats: both forms write the same bits.
"""
from __future__ import annotations

import torch

from .lr import LRScheduler


class TensorGroup:
    """Tensors of one type whose operators (+, -, *, /, unary -) each run
    as one ``torch._foreach_*`` call; the other operand is a scalar or a
    group of the same length."""

    __slots__ = ("ts",)

    def __init__(self, ts):
        self.ts = list(ts)

    @staticmethod
    def _arg(o):
        if isinstance(o, TensorGroup):
            return o.ts
        if isinstance(o, torch.Tensor) and o.dtype != torch.float32:
            # a device scalar (fp64) meets the tensors as a Python float
            # does in a foreach op: rounded to fp32
            return o.float()
        return o

    def __add__(self, o):
        return TensorGroup(torch._foreach_add(self.ts, self._arg(o)))

    __radd__ = __add__

    def __sub__(self, o):
        return TensorGroup(torch._foreach_sub(self.ts, self._arg(o)))

    def __mul__(self, o):
        return TensorGroup(torch._foreach_mul(self.ts, self._arg(o)))

    __rmul__ = __mul__

    def __truediv__(self, o):
        return TensorGroup(torch._foreach_div(self.ts, self._arg(o)))

    def __neg__(self):
        return TensorGroup(torch._foreach_neg(self.ts))


def sqrt(x: TensorGroup) -> TensorGroup:
    return TensorGroup(torch._foreach_sqrt(x.ts))


class Optimizer:
    # True on subclasses whose `_update` is ELEMENTWISE in the parameter
    # (each output element depends only on the same element of p/g/slots
    # and on scalars): only those may run grouped (`apply_fn(fused=True)`)
    _fusable = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        if parameters is None:
            raise ValueError("parameters is required")
        self._learning_rate = learning_rate
        self._parameter_list = list(parameters)
        self._grad_clip = grad_clip
        if weight_decay is None:
            self._weight_decay = 0.0
        elif isinstance(weight_decay, (int, float)):
            self._weight_decay = float(weight_decay)
        else:  # an L2Decay-like object
            self._weight_decay = float(getattr(
                weight_decay, "_coeff", getattr(weight_decay, "coeff", 0.0)))
        self._slots: dict = {}
        self._step_count = 0

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate.get_lr())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    # -- per-parameter slots and update ----------------------------------------
    def _init_slots(self, p: torch.Tensor) -> dict:
        return {}

    def _update(self, p, g, slots, lr, t, **kw):
        """(new p, new slots) from TensorGroups p, g and {name: group}."""
        raise NotImplementedError

    def _param_kw(self, name: str) -> dict:
        """Per-parameter static update options (decay exclusion), keyed by
        parameter name. Overridden by AdamW."""
        return {}

    def _decay_grad(self, p, g):
        """L2 regularization folded into the gradient (not decoupled)."""
        wd = self._weight_decay
        if not wd:
            return g
        return g + wd * p

    def _apply(self, ps, gs, slots, lr, t, kw, inplace=True):
        """One `_update` over parameters ``ps`` with gradients ``gs`` and
        slot dicts ``slots``; returns (the new parameters, the new slot
        dicts). ``inplace`` writes the new values into ``ps`` and into the
        slot tensors (and returns those tensors); otherwise both are left
        as they were and the new values come back as new tensors of their
        types. A slot whose new value has another shape or type than the
        old one (a loaded legacy state) is rebound instead. A gradient in
        another type than its parameter is taken in fp32, as in the
        reference."""
        gs = [g.float() if g.dtype != p.dtype else g for p, g in zip(ps, gs)]
        names = list(slots[0]) if slots else []
        s_in = {k: TensorGroup([s[k] for s in slots]) for k in names}
        new_p, new_s = self._update(TensorGroup(ps), TensorGroup(gs), s_in,
                                    lr, t, **kw)
        new_s = {k: list(v.ts) for k, v in new_s.items()}
        if inplace:
            torch._foreach_copy_(ps, new_p.ts)
            out = ps
            for k, new in new_s.items():
                old = s_in[k].ts if k in s_in else []
                fits = [i for i, q in enumerate(new) if i < len(old)
                        and old[i] is not q and old[i].shape == q.shape
                        and old[i].dtype == q.dtype]
                if fits:
                    torch._foreach_copy_([old[i] for i in fits],
                                         [new[i] for i in fits])
                    for i in fits:
                        new[i] = old[i]
        else:
            out = [q if q.dtype == p.dtype else q.to(p.dtype)
                   for p, q in zip(ps, new_p.ts)]
        return out, [{k: new_s[k][i] for k in new_s}
                     for i in range(len(ps))]

    @staticmethod
    def _param_name(p, i: int) -> str:
        return getattr(p, "param_name", None) or f"param_{i}"

    # -- eager step ----------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """Update every parameter that has a gradient, one at a time."""
        self._step_count += 1
        lr = self.get_lr()
        names = {id(p): self._param_name(p, i)
                 for i, p in enumerate(self._parameter_list)}
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        for p, g in params_grads:
            if g is None:
                continue
            slots = self._slots.get(id(p))
            if slots is None:
                slots = self._init_slots(p)
            self._slots[id(p)] = self._apply(
                [p], [g], [slots], lr, self._step_count,
                self._param_kw(names[id(p)]))[1][0]

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # -- functional interface (compiled training steps) ------------------------
    def init_state_tree(self, params: dict) -> dict:
        """{name: slot dict} for a {name: tensor} dict of parameters."""
        return {k: self._init_slots(p) for k, p in params.items()}

    @property
    def fused_update_supported(self) -> bool:
        """May `apply_fn(fused=True)` group this optimizer's update?"""
        return bool(type(self)._fusable)

    @staticmethod
    def _device_scalar(v, device) -> torch.Tensor:
        """``v`` as a 0-d fp64 tensor on ``device`` (a tensor is taken as
        it is)."""
        if isinstance(v, torch.Tensor):
            return v
        return torch.full((), float(v), dtype=torch.float64, device=device)

    @torch.no_grad()
    def apply_fn(self, params: dict, grads: dict, state: dict, lr=None,
                 t=1, fused=False, inplace=True):
        """Update ``params`` ({name: tensor}) and the slot tensors of
        ``state`` ({name: slot dict}) in place from ``grads``; returns
        (params, state). With ``inplace=False`` both keep their values,
        the first result is a new dict of new tensors (the reference's
        functional form) and ``state``'s dicts are rebound to new slot
        tensors, bit for bit what the in-place update writes.

        ``lr`` (None: ``get_lr()``) and ``t`` are 0-d fp64 tensors on the
        parameters' device, or numbers made into such tensors; every form
        of the update, the eager ``step()`` included, writes the same
        bits (see the module docstring).

        Parameters are taken in sorted name order (the reference's pytree
        order). ``fused=True`` (elementwise optimizers only) runs one
        `_update` per group of parameters sharing a type, device, options
        and slot layout; a parameter whose slots do not have its shape (a
        loaded legacy state) runs alone. The result equals the
        per-parameter loop element for element."""
        if not params:
            return params, state
        dev = next(iter(params.values())).device
        lr = self._device_scalar(self.get_lr() if lr is None else lr, dev)
        t = self._device_scalar(t, dev)
        if self._grad_clip is not None and hasattr(self._grad_clip,
                                                   "clip_fn"):
            grads = self._grad_clip.clip_fn(grads)
        names = sorted(params)
        groups: dict = {}
        for n in names:
            p, g, s = params[n], grads[n], state[n]
            kw_key = tuple(sorted(self._param_kw(n).items()))
            slots_ok = all(isinstance(v, torch.Tensor) and v.shape == p.shape
                           for v in s.values())
            if fused and self.fused_update_supported and slots_ok:
                key = (p.dtype, p.device, g.dtype == p.dtype, kw_key,
                       tuple(sorted((k, v.dtype) for k, v in s.items())))
            else:
                key = ("solo", n)
            groups.setdefault(key, []).append(n)
        out = params if inplace else dict(params)
        for group in groups.values():
            kw = dict(self._param_kw(group[0]))
            new_p, new_s = self._apply([params[n] for n in group],
                                       [grads[n] for n in group],
                                       [state[n] for n in group], lr, t, kw,
                                       inplace)
            for n, q, s in zip(group, new_p, new_s):
                out[n] = q
                if inplace:
                    state[n].update(s)
                else:
                    state[n] = s
        return out, state

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        sd = {"step": self._step_count}
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        for i, p in enumerate(self._parameter_list):
            for sname, sval in (self._slots.get(id(p)) or {}).items():
                sd[f"{self._param_name(p, i)}.{sname}"] = \
                    sval.detach().clone()
        return sd

    def set_state_dict(self, state_dict: dict):
        self._step_count = int(state_dict.get("step", 0))
        if isinstance(self._learning_rate, LRScheduler) \
                and "LR_Scheduler" in state_dict:
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        for i, p in enumerate(self._parameter_list):
            key = self._param_name(p, i) + "."
            slots = {k[len(key):]: torch.as_tensor(v, device=p.device).clone()
                     for k, v in state_dict.items() if k.startswith(key)}
            if slots:
                self._slots[id(p)] = slots
