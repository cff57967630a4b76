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


def _counters() -> dict:
    """{kernel: its module's launch counter dict}; the backward kernels
    have their own entries."""
    from . import (flash_attention, fused_bn, fused_conv_bn, layer_norm,
                   paged_attention, softmax_ce)
    return {"layer_norm": layer_norm._stats,
            "flash_attention": flash_attention._stats,
            "flash_attention_bwd": flash_attention._bwd_stats,
            "flash_attention_bwd_dq": flash_attention._bwd_dq_stats,
            "flash_attention_bwd_dkv": flash_attention._bwd_dkv_stats,
            "paged_attention": paged_attention._stats,
            "softmax_ce_fwd": softmax_ce._stats,
            "softmax_ce_bwd": softmax_ce._bwd_stats,
            "fused_bn_fwd": fused_bn._stats,
            "fused_bn_bwd_reduce": fused_bn._reduce_stats,
            "fused_bn_bwd_dx": fused_bn._dx_stats,
            "conv1x1_stats": fused_conv_bn._stats}


def all_stats() -> dict:
    """{kernel: its launch counters} for every kernel of the port."""
    return {name: dict(st) for name, st in _counters().items()}


def reset_stats() -> None:
    for st in _counters().values():
        for key in st:
            st[key] = 0
