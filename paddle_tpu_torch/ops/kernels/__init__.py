"""Hand-written Hopper kernels and their plain PyTorch versions.

One module per TPU kernel file of ``paddle_tpu/ops/pallas/`` (same file
stem). Each wrapper takes the CUDA kernel for a tensor on a card and the
plain version for a tensor on the CPU, and counts which one ran in its
module's ``_stats`` (``{"kernel": n, "plain": n}``). For a CUDA tensor
there is no fallback: the wrapper launches or raises.
"""
from __future__ import annotations

import torch

from ... import _native
from ..._platform import require_hopper


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        require_hopper(t.device)
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel or plain version for device {t.device}")


def same_device(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")


def launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry `entry` of the kernel library on `device`'s current
    stream (appended as the last argument) and raise on a CUDA error."""
    lib = _native.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _native.check(getattr(lib, entry)(*args, stream), name)


def all_stats() -> dict:
    """{kernel module: its _stats} for every kernel of the port."""
    from . import flash_attention, layer_norm, paged_attention
    return {"layer_norm": dict(layer_norm._stats),
            "flash_attention": dict(flash_attention._stats),
            "paged_attention": dict(paged_attention._stats)}


def reset_stats() -> None:
    from . import flash_attention, layer_norm, paged_attention
    for mod in (layer_norm, flash_attention, paged_attention):
        for key in mod._stats:
            mod._stats[key] = 0
