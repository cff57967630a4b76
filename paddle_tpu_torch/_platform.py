"""Device choice for the port.

Counterpart of ``paddle_tpu/ops/pallas/tiling.py:on_tpu`` and
``paddle_tpu/_platform.py``. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; when no card is present and none was
asked for they raise instead of carrying on quietly on the CPU. The
hand-written kernels are built for ``sm_90a`` only, so launching one
also requires a card of compute capability 9.0 (Hopper).
"""
from __future__ import annotations

import torch

#: the compute capability the kernels are compiled for (``sm_90a``)
KERNEL_CAPABILITY = (9, 0)


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for an entry point: ``cuda`` by default, the
    caller's choice otherwise. Raises when CUDA is asked for (explicitly
    or by default) and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev


def require_hopper(device: torch.device) -> None:
    """Raise unless `device` is a CUDA card of compute capability 9.0, the
    one the hand-written kernels are built for."""
    cap = (torch.cuda.get_device_capability(device)
           if device.type == "cuda" else None)
    if cap != KERNEL_CAPABILITY:
        raise RuntimeError(
            f"the paddle_tpu_torch kernels are built for sm_90a (compute "
            f"capability {KERNEL_CAPABILITY}); device {device} has {cap}")
