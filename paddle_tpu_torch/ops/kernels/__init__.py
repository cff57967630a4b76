"""Hand-written Hopper kernels and their plain PyTorch versions.

One module per TPU kernel file of ``paddle_tpu/ops/pallas/`` (same file
stem). Each wrapper takes the CUDA kernel for a tensor on a card and the
plain version for a tensor on the CPU, and counts which one ran in its
module's ``_stats`` (``{"kernel": n, "plain": n}``). For a CUDA tensor
there is no fallback: the wrapper launches or raises.

An input that the reference's dispatch sends to an XLA composition (fp16
or fp64 layer norm, attention, cross-entropy and fused BN; a masked
attention other than by a 4-D bool mask the flash kernels stream; causal
attention with Lq > Lk, or a head dim the flash kernels do not take) goes
to the module's torch composition instead, on the card as on the CPU. Each module's entry decides that with its ``kernel_takes``
and counts the run in :func:`composed_stats`, apart from ``_stats``.

The counters are Python, so a replayed CUDA graph counts nothing by
itself: :func:`recorded` sets aside what a capture counted and
:func:`add_counts` adds it once per replay.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from ... import _native
from ..._platform import require_hopper
from ...profiler import health as _health


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        require_hopper(t.device)
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel or plain version for device {t.device}")


def checked(op: str):
    """Decorate a wrapper's entry point so that, under FLAGS_check_nan_inf
    (or a health replay), its output is checked under the name `op` with
    the per-op check suspended inside it: the kernel's launch is invisible
    to the per-op check and its plain version's aten ops are not the
    reference's op (``profiler.health.run_checked``)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return _health.run_checked(op, fn, *args, **kwargs)
        return wrapper
    return deco


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


#: runs of each entry's torch composition (see the module docstring)
_composed = {"layer_norm": 0, "flash_attention": 0, "softmax_ce": 0,
             "fused_bn": 0}


def count_composed(name: str) -> None:
    _composed[name] += 1


def composed_stats() -> dict:
    """{entry: runs of its torch composition}."""
    return dict(_composed)


#: launches by design and by shape of the kernels with more than one
#: design (the flash forward and backwards, the 1x1 conv, the CE pair):
#: {kernel: {design: n}} and {kernel: {shape: n}}
_designs: dict = {}
_shapes: dict = {}


def count_design(name: str, design: str, shape: str | None = None) -> None:
    """Count one launch of kernel `name` under `design` (and `shape`)."""
    d = _designs.setdefault(name, {})
    d[design] = d.get(design, 0) + 1
    if shape is not None:
        d = _shapes.setdefault(name, {})
        d[shape] = d.get(shape, 0) + 1


def design_stats() -> dict:
    """{kernel: {design: launches}} since the last :func:`reset_stats`."""
    return {k: dict(v) for k, v in _designs.items()}


def shape_stats() -> dict:
    """{kernel: {shape: launches}} since the last :func:`reset_stats`."""
    return {k: dict(v) for k, v in _shapes.items()}


def _counters() -> dict:
    """{kernel: its module's launch counter dict}; the backward kernels
    have their own entries, and so do the flash kernels' launches with
    the bool-mask operand (``*_masked``)."""
    from . import (flash_attention, fused_bn, fused_conv_bn, layer_norm,
                   paged_attention, softmax_ce)
    return {"layer_norm": layer_norm._stats,
            "layer_norm_bwd": layer_norm._bwd_stats,
            "flash_attention": flash_attention._stats,
            "flash_attention_bwd": flash_attention._bwd_stats,
            "flash_attention_bwd_dq": flash_attention._bwd_dq_stats,
            "flash_attention_bwd_dkv": flash_attention._bwd_dkv_stats,
            "flash_attention_masked": flash_attention._mask_stats,
            "flash_attention_bwd_masked": flash_attention._bwd_mask_stats,
            "flash_attention_bwd_dq_masked":
                flash_attention._bwd_dq_mask_stats,
            "flash_attention_bwd_dkv_masked":
                flash_attention._bwd_dkv_mask_stats,
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
    """Every launch counter, design and shape count and composition count
    to 0."""
    for st in (*_counters().values(), _composed):
        for key in st:
            st[key] = 0
    _designs.clear()
    _shapes.clear()


def _all_counts() -> dict:
    return {"stats": all_stats(), "designs": design_stats(),
            "shapes": shape_stats(), "composed": composed_stats()}


def _set_counts(counts: dict) -> None:
    for name, st in _counters().items():
        st.update(counts["stats"][name])
    _composed.update(counts["composed"])
    for live, saved in ((_designs, counts["designs"]),
                        (_shapes, counts["shapes"])):
        live.clear()
        live.update({k: dict(v) for k, v in saved.items()})


@contextlib.contextmanager
def recorded():
    """Count the block's launches apart, for a CUDA graph captured in it:
    a capture runs each wrapper's Python (which counts) but launches
    nothing. On exit every counter is as it was before the block, and the
    yielded dict holds what the block counted, in the shape
    :func:`add_counts` adds once per replay of the graph."""
    before = _all_counts()
    rec: dict = {}
    try:
        yield rec
        after = _all_counts()
        rec["stats"] = {
            name: {k: n - before["stats"][name][k] for k, n in st.items()}
            for name, st in after["stats"].items()}
        rec["composed"] = {k: n - before["composed"][k]
                           for k, n in after["composed"].items()}
        for part in ("designs", "shapes"):
            rec[part] = {
                name: {k: n - before[part].get(name, {}).get(k, 0)
                       for k, n in by.items()}
                for name, by in after[part].items()}
    finally:
        _set_counts(before)


def add_counts(rec: dict) -> None:
    """Add the launches :func:`recorded` held for a graph: one replay."""
    for name, st in _counters().items():
        for k, n in rec["stats"][name].items():
            st[k] += n
    for k, n in rec["composed"].items():
        _composed[k] += n
    for live, part in ((_designs, rec["designs"]), (_shapes, rec["shapes"])):
        for name, by in part.items():
            d = live.setdefault(name, {})
            for k, n in by.items():
                if n:
                    d[k] = d.get(k, 0) + n
