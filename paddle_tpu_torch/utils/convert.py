"""Carry weights across from the JAX package.

Parameter and buffer names and layouts are paddle's in both packages
(``blocks.0.attn.qkv.weight``, ``Linear.weight`` as [in, out],
``layer1.0.bn1._mean``), so a JAX model's parameters and buffers, exported
as numpy arrays (``{k: np.asarray(v.data)}`` over ``named_parameters()``
and ``named_buffers()``), load one to one. A JAX ``TrainStep``'s state
(``state_dict()``, its ``params`` and its ``buffers``) loads into the
port's ``TrainStep`` the same way, so both can resume from one
checkpoint."""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _copy_numpy(own: Mapping[str, torch.Tensor],
                params: Mapping[str, np.ndarray], strict: bool,
                who: str) -> None:
    if strict:
        missing = sorted(set(own) - set(params))
        unexpected = sorted(set(params) - set(own))
        if missing or unexpected:
            raise KeyError(f"{who}: missing {missing}, unexpected "
                           f"{unexpected}")
    with torch.no_grad():
        for name, arr in params.items():
            p = own.get(name)
            if p is None:
                continue
            arr = np.array(arr, dtype=np.float32)  # a writable copy
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{who}: {name} is {tuple(arr.shape)}, "
                                 f"the module holds {tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))


def load_numpy_params(module: torch.nn.Module,
                      params: Mapping[str, np.ndarray],
                      strict: bool = True) -> None:
    """Copy ``params`` ({name: array} of parameters and buffers, such as
    batch norm's running statistics) into ``module``'s parameters and
    buffers in place, keeping each one's device and type. With ``strict``,
    a missing or unexpected name raises; a shape mismatch always raises."""
    own = {**dict(module.named_parameters()), **dict(module.named_buffers())}
    _copy_numpy(own, params, strict, "load_numpy_params")


def load_train_state(step, state_dict: Mapping,
                     params: Mapping[str, np.ndarray] | None = None,
                     buffers: Mapping[str, np.ndarray] | None = None
                     ) -> None:
    """Resume the port's ``jit.TrainStep`` ``step`` from a JAX
    ``TrainStep``: ``state_dict`` is its ``state_dict()`` (``{"t",
    "opt_flat"}``, the optimizer slots in ``jax.tree_util`` leaf order:
    sorted parameter names, then sorted slot names) and ``params``, when
    given, its parameters ({name: array}, e.g. ``{k: np.asarray(v) for k, v
    in jstep.params.items()}``), copied into the step's fp32 masters, and
    ``buffers``, when given, its buffers (``jstep.buffers``, e.g. batch
    norm's running statistics), copied into the step's; then both go into
    its layer."""
    step.set_state_dict({"t": state_dict["t"],
                         "opt_flat": [np.asarray(v) for v in
                                      state_dict["opt_flat"]]})
    if params is not None:
        _copy_numpy(step.params, params, True, "load_train_state")
    if buffers is not None:
        _copy_numpy(step.buffers, buffers, True, "load_train_state")
    if params is not None or buffers is not None:
        step.sync_to_layer()
