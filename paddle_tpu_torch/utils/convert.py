"""Carry weights across from the JAX package.

Parameter names and layouts are paddle's in both packages
(``blocks.0.attn.qkv.weight``, ``Linear.weight`` as [in, out]), so a
JAX model's parameters, exported as numpy arrays
(``{k: np.asarray(p.data) for k, p in model.named_parameters()}``), load
one to one."""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def load_numpy_params(module: torch.nn.Module,
                      params: Mapping[str, np.ndarray],
                      strict: bool = True) -> None:
    """Copy ``params`` ({name: array}) into ``module``'s parameters in
    place, keeping each parameter's device and type. With ``strict``, a
    missing or unexpected name raises; a shape mismatch always raises."""
    own = dict(module.named_parameters())
    if strict:
        missing = sorted(set(own) - set(params))
        unexpected = sorted(set(params) - set(own))
        if missing or unexpected:
            raise KeyError(f"load_numpy_params: missing {missing}, "
                           f"unexpected {unexpected}")
    with torch.no_grad():
        for name, arr in params.items():
            p = own.get(name)
            if p is None:
                continue
            arr = np.array(arr, dtype=np.float32)  # a writable copy
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"load_numpy_params: {name} is "
                                 f"{tuple(arr.shape)}, the module holds "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))
