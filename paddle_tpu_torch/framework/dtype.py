"""Dtype names to ``torch.dtype`` (counterpart of
``paddle_tpu/framework/dtype.py``), for the types the port supports:
float32 and bfloat16 for weights and activations."""
from __future__ import annotations

import torch

_STR2DTYPE = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}


def convert_dtype(dtype) -> torch.dtype | None:
    """Normalize a dtype given as a name or a ``torch.dtype``."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _STR2DTYPE:
        raise ValueError(f"unknown or unsupported dtype {dtype!r}; "
                         f"expected one of {sorted(_STR2DTYPE)}")
    return _STR2DTYPE[dtype]
