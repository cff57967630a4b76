"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

Each clip works eagerly on a list of (param, grad) pairs (the optimizer's
``step``) and, through ``clip_fn``, on a {name: grad} dict (the compiled
training step's ``apply_fn``). Norms are taken in fp32.
"""
from __future__ import annotations

import torch


class ClipGradBase:
    def clip_fn(self, grads: dict) -> dict:
        raise NotImplementedError

    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def clip_fn(self, grads):
        return {k: g.clamp(self.min, self.max) for k, g in grads.items()}

    def __call__(self, params_grads):
        return [(p, None if g is None else g.clamp(self.min, self.max))
                for p, g in params_grads]


def _scaled(g, norm, clip_norm):
    """g * min(clip_norm / max(norm, 1e-12), 1), in g's type."""
    scale = torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return (g * scale).to(g.dtype)


class ClipGradByNorm(ClipGradBase):
    """Clip each gradient to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, g):
        return _scaled(g, torch.linalg.vector_norm(g.float()), self.clip_norm)

    def clip_fn(self, grads):
        return {k: self._clip(g) for k, g in grads.items()}

    def __call__(self, params_grads):
        return [(p, None if g is None else self._clip(g))
                for p, g in params_grads]


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by min(clip_norm / global norm, 1), where the
    global norm is that of all gradients together."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @staticmethod
    def global_norm(grads) -> torch.Tensor:
        norms = torch._foreach_norm([g.float() for g in grads])
        return torch.linalg.vector_norm(torch.stack(norms))

    def clip_fn(self, grads):
        if not grads:
            return grads
        gn = self.global_norm(list(grads.values()))
        return {k: _scaled(g, gn, self.clip_norm) for k, g in grads.items()}

    def __call__(self, params_grads):
        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        gn = self.global_norm(grads)
        return [(p, g if g is None or not getattr(p, "need_clip", True)
                 else _scaled(g, gn, self.clip_norm))
                for p, g in params_grads]
