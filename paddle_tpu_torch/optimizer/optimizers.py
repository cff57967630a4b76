"""Concrete optimizers (counterpart of ``paddle_tpu/optimizer/optimizers.py``):
SGD, Momentum, Adam and AdamW, with the reference's update formulas in
fp32 slots. Each ``_update`` takes TensorGroups (see ``optimizer.py``).

AdamW decays EVERY parameter (layer norms and biases included) unless
``apply_decay_param_fun`` says otherwise, and its update is
``p * (1 - lr * wd) - lr * mhat / (sqrt(vhat) + eps)``, written out here
rather than taken from ``torch.optim.AdamW``, whose rounding differs.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer, sqrt


def _zeros32(p):
    return torch.zeros_like(p, dtype=torch.float32)


class SGD(Optimizer):
    _fusable = True  # p - lr*g is elementwise

    def _update(self, p, g, slots, lr, t, **kw):
        g = self._decay_grad(p, g)
        return p - lr * g, slots


class Momentum(Optimizer):
    _fusable = True

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_slots(self, p):
        return {"velocity": _zeros32(p)}

    def _update(self, p, g, slots, lr, t, **kw):
        g = self._decay_grad(p, g)
        v = self._momentum * slots["velocity"] + g
        if self._nesterov:
            new_p = p - lr * (g + self._momentum * v)
        else:
            new_p = p - lr * v
        return new_p, {"velocity": v}


class Adam(Optimizer):
    _fusable = True  # AdamW inherits this

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_slots(self, p):
        return {"moment1": _zeros32(p), "moment2": _zeros32(p)}

    def _moments(self, g, slots, t):
        m = self._beta1 * slots["moment1"] + (1 - self._beta1) * g
        v = self._beta2 * slots["moment2"] + (1 - self._beta2) * g * g
        mhat = m / (1 - self._beta1 ** t)
        vhat = v / (1 - self._beta2 ** t)
        return m, v, mhat, vhat

    def _update(self, p, g, slots, lr, t, **kw):
        g = self._decay_grad(p, g)
        m, v, mhat, vhat = self._moments(g, slots, t)
        new_p = p - lr * mhat / (sqrt(vhat) + self._eps)
        return new_p, {"moment1": m, "moment2": v}


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        self._wd = (float(weight_decay)
                    if isinstance(weight_decay, (int, float))
                    else float(getattr(weight_decay, "_coeff", 0.01)))
        self._apply_decay_param_fun = apply_decay_param_fun

    def _param_kw(self, name):
        if self._apply_decay_param_fun is not None:
            return {"decay": bool(self._apply_decay_param_fun(name))}
        return {}

    def _update(self, p, g, slots, lr, t, decay=True, **kw):
        m, v, mhat, vhat = self._moments(g, slots, t)
        # decoupled weight decay, skipped for excluded params
        wd = self._wd if decay else 0.0
        new_p = p * (1 - lr * wd) - lr * mhat / (sqrt(vhat) + self._eps)
        return new_p, {"moment1": m, "moment2": v}
