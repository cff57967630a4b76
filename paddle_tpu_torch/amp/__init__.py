"""AMP: ``auto_cast`` (alias ``amp_guard``), ``decorate`` and ``GradScaler``
(counterpart of ``paddle_tpu/amp/__init__.py``).

``auto_cast`` sets the op-name lists of ``ops/_dispatch.py`` (O1: products
in the amp type, losses and norms in float32, the rest following their
inputs); ``decorate(level="O2")`` casts a model's float32 parameters to
the amp type. bf16 needs no loss scaling; ``GradScaler`` scales
dynamically for float16. Unscaling and the finite check are one pass over
all gradients with one host sync, as the reference's
``_unscale_and_check`` (l.33) is one program. ``GradScaler`` keeps the
reference's metrics: ``amp_found_inf_total`` counts the unscale passes
that found a nonfinite gradient, ``amp_loss_scale`` holds the newest
scale.
"""
from __future__ import annotations

import contextlib

import torch

from ..ops._dispatch import amp_state
from ..profiler import metrics as _metrics_mod

_REG = _metrics_mod.default_registry()
_M_FOUND_INF = _REG.counter(
    "amp_found_inf_total",
    "GradScaler unscale passes that found nonfinite scaled gradients "
    "(each one skips the optimizer step and feeds the loss-scale backoff)")
_M_LOSS_SCALE = _REG.gauge(
    "amp_loss_scale",
    "current dynamic loss scale of the newest GradScaler — a collapsing "
    "value means gradients keep overflowing")


def _amp_dtype(dtype) -> torch.dtype:
    """The reference's rule: bfloat16 by name, float16 for anything else."""
    return (torch.bfloat16 if dtype in ("bfloat16", "bf16", torch.bfloat16)
            else torch.float16)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """Autocast by op name inside the block. ``level`` is recorded, as in
    the reference; the lists apply at every level (O2's parameters are
    cast once by ``decorate``)."""
    st = amp_state()
    prev = dict(st)
    st["enabled"] = bool(enable)
    st["level"] = level
    st["dtype"] = _amp_dtype(dtype)
    st["custom_white"] = set(custom_white_list or ())
    st["custom_black"] = set(custom_black_list or ())
    try:
        yield
    finally:
        st.update(prev)


amp_guard = auto_cast  # legacy alias


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast the models' float32 parameters to the amp type in place
    (the optimizer keeps its slots in the parameters' type, as the
    reference's does). O1 leaves them."""
    amp = _amp_dtype(dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.dtype == torch.float32:
                        p.data = p.data.to(amp)
    if optimizers is None:
        return models
    return models, optimizers


def _unscale_and_check(grads, inv: float) -> bool:
    """Multiply every gradient (all on one device) by ``inv`` in place and
    say whether any element is not finite: one multi-tensor pass and one
    host sync."""
    dev = grads[0].device
    found = torch.zeros(1, device=dev)
    torch._amp_foreach_non_finite_check_and_unscale_(
        grads, found, torch.full((1,), inv, device=dev))
    return bool(found.item())


class GradScaler:
    """Dynamic loss scaling (needed for float16; a pass-through scale for
    bf16 is harmless). The scale backs off by ``decr_ratio`` (never below
    1) after ``decr_every_n_nan_or_inf`` consecutive steps with a
    non-finite gradient, each of which skips the optimizer's step, and
    grows by ``incr_ratio`` after ``incr_every_n_steps`` finite ones."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False
        if enable and _metrics_mod.enabled():
            _M_LOSS_SCALE.set(self._scale)

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    def unscale_(self, optimizer):
        """Unscale the optimizer's gradients in place (once a step) and
        record whether any is not finite."""
        if not self._enable or self._unscaled:
            return
        grads = [p.grad for p in optimizer._parameter_list
                 if p.grad is not None]
        self._found_inf = (_unscale_and_check(grads, 1.0 / self._scale)
                           if grads else False)
        self._unscaled = True
        if self._found_inf and _metrics_mod.enabled():
            _M_FOUND_INF.inc()

    def step(self, optimizer):
        """Unscale, step the optimizer unless a gradient is not finite,
        and update the scale."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()
        self._unscaled = False

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False
        if _metrics_mod.enabled():
            # scale as a gauge: loss-scale collapse is visible in a snapshot
            _M_LOSS_SCALE.set(self._scale)

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return torch.tensor(self._scale)

    def set_init_loss_scaling(self, v):
        self._scale = float(v)
        if self._enable and _metrics_mod.enabled():
            _M_LOSS_SCALE.set(self._scale)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)
        if self._enable and _metrics_mod.enabled():
            _M_LOSS_SCALE.set(self._scale)


__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler"]
