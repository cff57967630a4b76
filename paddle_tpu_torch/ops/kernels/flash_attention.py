"""Flash attention: the forward and backward CUDA kernels
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``), their plain
PyTorch versions, the autograd Function that carries them, and the
dispatch ``flash_attention``.

Forward: replaces ``_fa_fwd_pallas`` (tiled online softmax) and
``_fa_small_fwd_pallas`` (single-shot path for Lq == Lk <= 512) of
``paddle_tpu/ops/pallas/flash_attention.py``. One Hopper kernel covers
both. It is bound by operations; for a 64-row query tile it streams K/V
tiles through shared memory, skips tiles above the causal diagonal, masks
row and column tails (any L >= 1), and reads [B, L, H, D] through its
strides. Outputs are ``out`` in the input type and ``lse`` [B, H, Lq]
fp32, which the backward reuses.

Designs (``fwd_design``, ``bwd_design``): at head dim 64 or 128 with
16-byte aligned rows, bf16 runs the forward, the one-pass backward and
the split backward pair on the tensor cores (``mma.sync`` m16n8k16, fp32
accumulators, P and dS rounded to bf16 before the products that read
them, as the reference does), and fp32 runs them on the TF32 tensor
cores in a 3xTF32 split (``mma.sync`` m16n8k8: each operand split into a
TF32 hi and lo part, each product hi hi + hi lo + lo hi in fp32, which
keeps fp32 accuracy); other head dims and unaligned rows run on CUDA
cores. Every launch counts the design its C entry reports
(``design_stats``).

Backward, chosen by the reference's gate (l.1109): while the one-pass
kernel's whole-(b, h) dq, Lq * D * 4 bytes, fits ``_FUSED_BWD_DQ_BYTES``
(6 MiB, l.955), the one-pass kernel (``csrc/flash_attention_bwd.cu``)
replaces ``_fa_bwd_fused_pallas`` and ``_fa_small_bwd_pallas``: one block
per (64-key tile, b*h) walks the q tiles at or below the diagonal, forms
P and dS once per tile pair, keeps dk/dv in fp32 for its lifetime and adds
dq into an fp32 buffer with atomics (so dq's summation order varies from
run to run; dk and dv repeat bit for bit). Above the gate (past 24,576 tokens at
D = 64) the split pair (``csrc/flash_attention_bwd_split.cu``) replaces
``_fa_bwd_pallas``: a dq kernel walks the k tiles for each q tile and a
dk/dv kernel the q tiles for each k tile, each writing its outputs once,
without atomics. delta = rowsum(dO * O) is a torch composition, computed
once for either, as it is XLA in the reference (l.970, 1023). See the
sources for the designs.

The bool mask (the reference's ``_apply_mask``, l.164): every kernel and
plain version takes an optional 4-D bool mask whose dims are each 1 or
full against [B, H, Lq, Lk] (``mask_takes``, the reference's gate at
l.1240-1251), True = attend. The kernels read it through four element
strides, 0 on a broadcast dim, so an expanded [B, 1, 1, Lk] key-padding
mask is never materialised, and drop a masked score to -inf before the
running max. A row with no visible key gives out exactly 0, lse -inf
and dq 0, and adds nothing to dk or dv. A launch or plain run with a
mask counts in its kernel's ``*_mask_stats`` in place of ``_stats``. A
float mask (its gradient is real), a mask of another rank and one that
does not broadcast compose.

``FlashAttentionFunction`` is the counterpart of the ``jax.custom_vjp`` at
l.1118-1155: one Function on both devices, whose forward and backward
launch the kernels for CUDA tensors and run the plain versions for CPU
ones; it saves the mask and gives it no gradient.

Layout convention (paddle): q/k/v are [batch, seq, heads, head_dim].
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...framework import random as _random
from . import (checked, count_composed, count_design, launch, same_device,
               use_kernel)

_stats = {"kernel": 0, "plain": 0}
#: launches of the one-pass backward kernel (and runs of its plain version)
_bwd_stats = {"kernel": 0, "plain": 0}
#: launches of the split backward's dq and dk/dv kernels (and plain runs)
_bwd_dq_stats = {"kernel": 0, "plain": 0}
_bwd_dkv_stats = {"kernel": 0, "plain": 0}
#: the same four with the bool-mask operand: a masked launch (or plain
#: run) counts here and not above
_mask_stats = {"kernel": 0, "plain": 0}
_bwd_mask_stats = {"kernel": 0, "plain": 0}
_bwd_dq_mask_stats = {"kernel": 0, "plain": 0}
_bwd_dkv_mask_stats = {"kernel": 0, "plain": 0}


def _count(unmasked, masked, mask, route):
    (unmasked if mask is None else masked)[route] += 1


#: the one-pass backward's whole-(b, h) dq bound (reference l.955): above
#: it, Lq * D * 4 bytes, the split pair runs
_FUSED_BWD_DQ_BYTES = 6 * 1024 * 1024

_TYPES = (torch.float32, torch.bfloat16)
_MAX_D = 128


def _visible(q, k, causal, mask):
    """[.., Lq, Lk] bool, True where a query row sees a key: the causal
    triangle (kv_offset = Lk - Lq) and the bool mask, broadcast; None when
    every key is visible."""
    Lq, Lk = q.shape[1], k.shape[1]
    keep = None
    if causal:
        keep = torch.ones(Lq, Lk, dtype=torch.bool, device=q.device).tril(
            diagonal=Lk - Lq)
    if mask is not None:
        keep = mask if keep is None else keep & mask
    return keep


def flash_attention_plain(q, k, v, causal: bool = False, scale=None,
                          mask=None):
    """(out [B, Lq, H, D] in q's type, lse [B, H, Lq] fp32), in fp32.
    Causal masking uses kv_offset = Lk - Lq; ``mask`` is a bool
    [B|1, H|1, Lq|1, Lk|1] mask (True = attend); a masked score is -inf,
    and a row with no visible key gives out exactly 0 and lse -inf."""
    B, Lq, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * scale
    keep = _visible(q, k, causal, mask)
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhlm,bmhd->blhd", p / l, v.float()).to(q.dtype)
    lse = (s.amax(dim=-1, keepdim=True) + torch.log(l)).squeeze(-1)
    return out, lse


def check_args(q, k, v, causal: bool) -> None:
    """What the CUDA kernel takes; raises ValueError on anything else."""
    same_device("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, L, H, D]")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _TYPES:
        raise ValueError(f"flash_attention: types {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes one of float32 and "
                         f"bfloat16")
    B, Lq, H, D = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (B, H, D):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if D > _MAX_D or D % 8:
        raise ValueError(f"flash_attention: head dim {D}; the kernel takes "
                         f"D <= {_MAX_D}, a multiple of 8")
    if min(Lq, k.shape[1]) < 1:
        raise ValueError("flash_attention: empty sequence")
    if causal and Lq > k.shape[1]:
        raise ValueError("flash_attention: causal with Lq > Lk leaves rows "
                         "with no visible key")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: head_dim must be contiguous")
    if B > 65535 or H > 65535:
        raise ValueError("flash_attention: B and H must be <= 65535")


def mask_takes(q, k, mask) -> bool:
    """Whether the kernels (their plain versions on the CPU) take ``mask``,
    as the reference's ``_pallas_eligible`` does (l.1240-1251): a 4-D
    bool mask whose dims are each 1 or full against [B, H, Lq, Lk]. A
    float mask composes, since its gradient is real (l.1241-1247), and so
    does a mask of another rank or one that does not broadcast."""
    if mask is None:
        return True
    if mask.dim() != 4 or mask.dtype != torch.bool:
        return False
    B, Lq, H, _ = q.shape
    return all(n in (1, full) for n, full in zip(mask.shape,
                                                 (B, H, Lq, k.shape[1])))


def kernel_takes(q, k, v, mask=None, causal: bool = False) -> bool:
    """Whether the flash kernels take this attention on a card: the
    counterpart of the reference's ``_pallas_eligible`` (l.1217-1253).
    False, and ``flash_attention`` composes, for fp16 or fp64 (or mixed)
    types, causal with Lq > Lk (rows with no visible key), a head dim
    above 128 or not a multiple of 8 (the reference's compile probe,
    ``_pallas_fa_ok``, fails there) and a mask ``mask_takes`` refuses."""
    if not mask_takes(q, k, mask):
        return False
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _TYPES:
        return False
    D = q.shape[-1]
    if D > _MAX_D or D % 8:
        return False
    return not (causal and q.shape[1] > k.shape[1])


def _tc_shape(*tensors) -> bool:
    """D 64 or 128 with every row of every [B, L, H, D] tensor 16-byte
    aligned, strides counted in bytes (``csrc/mma.cuh:rows_aligned16``)."""
    return tensors[0].shape[-1] in (64, 128) and all(
        t.data_ptr() % 16 == 0
        and all(st * t.element_size() % 16 == 0 for st in t.stride()[:3])
        for t in tensors)


def _design(q, *tensors) -> str:
    """On the tensor cores at D 64 or 128 with every row aligned,
    "mma.sync" for bf16 and "mma.sync-3xtf32" for fp32; else
    "cuda-core"."""
    if not _tc_shape(q, *tensors):
        return "cuda-core"
    return "mma.sync" if q.dtype == torch.bfloat16 else "mma.sync-3xtf32"


def fwd_design(q, k, v) -> str:
    """The design the forward launcher (``csrc/flash_attention.cu``)
    picks for these inputs (``_design``). A prediction: the launch counts
    the design its C entry reports (``DESIGNS``)."""
    return _design(q, k, v)


def bwd_design(q, k, v, do) -> str:
    """The design the backward launchers (one-pass and split) pick, as
    ``csrc/flash_attention_bwd.cuh:tc_takes`` picks it (``_design``, dO's
    rows aligned too). A prediction, as ``fwd_design`` is."""
    return _design(q, k, v, do)


#: the designs by the code the C entries report (``csrc/mma.cuh:Design``)
DESIGNS = ("cuda-core", "mma.sync", "mma.sync-3xtf32")


def _check_mask(q, k, mask) -> None:
    """Raise ValueError unless the kernels take ``mask`` (``mask_takes``)."""
    if not mask_takes(q, k, mask):
        raise ValueError(
            f"flash_attention: mask {mask.dtype} {tuple(mask.shape)}; the "
            f"kernels take a 4-D bool mask whose dims are each 1 or full "
            f"against {(q.shape[0], q.shape[2], q.shape[1], k.shape[1])}")


def _mask_args(q, k, mask):
    """The mask operand of the C entries, for a mask the caller has
    checked (``_check_mask``): (pointer, its four element strides over
    [B, H, Lq, Lk], 0 on a broadcast dim, so an expanded mask is never
    materialised), or a null pointer and zeros."""
    if mask is None:
        return None, (0, 0, 0, 0)
    same_device("flash_attention", q, mask)
    B, Lq, H, _ = q.shape
    m = mask.expand(B, H, Lq, k.shape[1])
    return m.data_ptr(), m.stride()


def flash_attention_fwd(q, k, v, causal: bool = False, scale=None,
                        mask=None):
    """Attention forward: (out [B, Lq, H, D], lse [B, H, Lq] fp32), with
    an optional bool mask (``mask_takes``; True = attend)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _check_mask(q, k, mask)
    if not use_kernel(q):
        _count(_stats, _mask_stats, mask, "plain")
        return flash_attention_plain(q, k, v, causal, scale, mask)
    check_args(q, k, v, causal)
    mptr, mstrides = _mask_args(q, k, mask)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    design = ctypes.c_int(-1)
    launch("flash_attention", "pt_flash_attention_fwd", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           lse.data_ptr(), mptr, *q.stride()[:3], *k.stride()[:3],
           *v.stride()[:3], *mstrides, B, H, Lq, Lk, D, int(bool(causal)),
           float(scale), int(q.dtype == torch.bfloat16),
           ctypes.byref(design))
    _count(_stats, _mask_stats, mask, "kernel")
    _count_design("flash_attention", mask, design)
    return out, lse


def _count_design(name, mask, design) -> None:
    """Count a launch of kernel `name` (its ``_masked`` counter with a
    mask) under the design its C entry reported into ``design``."""
    count_design(name if mask is None else name + "_masked",
                 DESIGNS[design.value])


def _p_ds(q, k, v, lse, delta, do, causal, scale, mask=None):
    """(P, dS) [B, H, Lq, Lk] fp32: P = exp(S * scale - lse) (0 above the
    causal diagonal and where the bool mask is False, so a row with no
    visible key, lse -inf, gives 0) and dS = P * (dP - delta),
    dP = dO V^T."""
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None])
    del s
    keep = _visible(q, k, causal, mask)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    dp = torch.einsum("blhd,bmhd->bhlm", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_plain(q, k, v, lse, delta, do, causal: bool = False,
                              scale=None, mask=None):
    """(dq, dk, dv) in q's type, computed in fp32 from P = exp(S * scale -
    lse) and dS = P * (dP - delta), with delta = rowsum(dO * O) [B, H, Lq]
    fp32 (the TPU kernels' arithmetic), under the same optional bool mask
    as the forward."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds = _p_ds(q, k, v, lse, delta, do, causal, scale, mask)
    dv = torch.einsum("bhlm,blhd->bmhd", p, do.float())
    dq = torch.einsum("bhlm,bmhd->blhd", ds, k.float()) * scale
    dk = torch.einsum("bhlm,blhd->bmhd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, lse, delta, do,
                                 causal: bool = False, scale=None,
                                 mask=None):
    """dq = dS K * scale in q's type, computed in fp32 (the split
    backward's dq walk, reference l.282)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _, ds = _p_ds(q, k, v, lse, delta, do, causal, scale, mask)
    return (torch.einsum("bhlm,bmhd->blhd", ds, k.float()) * scale).to(
        q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, lse, delta, do,
                                  causal: bool = False, scale=None,
                                  mask=None):
    """(dk, dv) = (dS^T Q * scale, P^T dO) in k's type, computed in fp32
    (the split backward's dk/dv walk, reference l.353)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds = _p_ds(q, k, v, lse, delta, do, causal, scale, mask)
    dv = torch.einsum("bhlm,blhd->bmhd", p, do.float())
    del p
    dk = torch.einsum("bhlm,blhd->bmhd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def uses_split_bwd(Lq: int, D: int) -> bool:
    """The reference's choice of backward (l.1109): the split pair when
    the one-pass kernel's whole-(b, h) dq, Lq * D * 4 bytes, passes
    ``_FUSED_BWD_DQ_BYTES``."""
    return Lq * D * 4 > _FUSED_BWD_DQ_BYTES


def attention_delta(out, do):
    """delta = rowsum(dO * O) as [B, H, Lq] fp32 (l.970)."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _bwd_launch_args(q, k, v, lse, delta, do, causal, scale, mask):
    """Checks what the backward kernels take; returns (do, lse, delta)
    ready for them and the mask pointer, strides and sizes every entry
    takes before its design out-parameter."""
    check_args(q, k, v, causal)
    _check_mask(q, k, mask)
    mptr, mstrides = _mask_args(q, k, mask)
    same_device("flash_attention_bwd", q, do, lse, delta)
    B, Lq, H, D = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: do {tuple(do.shape)} "
                         f"{do.dtype} against q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, H, Lq) or delta.shape != (B, H, Lq):
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)}, "
                         f"delta {tuple(delta.shape)}, want {(B, H, Lq)}")
    if B * H > 65535:
        raise ValueError("flash_attention_bwd: B * H must be <= 65535")
    if do.stride(-1) != 1:
        do = do.contiguous()
    lse = lse.float().contiguous()
    delta = delta.float().contiguous()
    tail = (mptr, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], *mstrides, B, H, Lq, k.shape[1], D,
            int(bool(causal)), float(scale), int(q.dtype == torch.bfloat16))
    return do, lse, delta, tail


def flash_attention_bwd_dq(q, k, v, lse, delta, do, causal: bool = False,
                           scale=None, mask=None):
    """The split backward's dq [B, Lq, H, D] in q's type: the dq kernel
    for CUDA tensors, its plain version for CPU ones."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not use_kernel(q):
        _count(_bwd_dq_stats, _bwd_dq_mask_stats, mask, "plain")
        return flash_attention_bwd_dq_plain(q, k, v, lse, delta, do, causal,
                                            scale, mask)
    do, lse, delta, tail = _bwd_launch_args(q, k, v, lse, delta, do, causal,
                                            scale, mask)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    design = ctypes.c_int(-1)
    launch("flash_attention_bwd_dq", "pt_flash_attention_bwd_dq", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *tail,
           ctypes.byref(design))
    _count(_bwd_dq_stats, _bwd_dq_mask_stats, mask, "kernel")
    _count_design("flash_attention_bwd_dq", mask, design)
    return dq


def flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal: bool = False,
                            scale=None, mask=None):
    """The split backward's (dk, dv) [B, Lk, H, D] in k's type: the dk/dv
    kernel for CUDA tensors, its plain version for CPU ones."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not use_kernel(q):
        _count(_bwd_dkv_stats, _bwd_dkv_mask_stats, mask, "plain")
        return flash_attention_bwd_dkv_plain(q, k, v, lse, delta, do, causal,
                                             scale, mask)
    do, lse, delta, tail = _bwd_launch_args(q, k, v, lse, delta, do, causal,
                                            scale, mask)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    design = ctypes.c_int(-1)
    launch("flash_attention_bwd_dkv", "pt_flash_attention_bwd_dkv",
           q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
           *tail, ctypes.byref(design))
    _count(_bwd_dkv_stats, _bwd_dkv_mask_stats, mask, "kernel")
    _count_design("flash_attention_bwd_dkv", mask, design)
    return dk, dv


def flash_attention_bwd_fused(q, k, v, lse, delta, do, causal: bool = False,
                              scale=None, mask=None):
    """The one-pass backward's (dq, dk, dv) in q's type: its kernel for
    CUDA tensors, its plain version for CPU ones."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not use_kernel(q):
        _count(_bwd_stats, _bwd_mask_stats, mask, "plain")
        return flash_attention_bwd_plain(q, k, v, lse, delta, do, causal,
                                         scale, mask)
    do, lse, delta, tail = _bwd_launch_args(q, k, v, lse, delta, do, causal,
                                            scale, mask)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    design = ctypes.c_int(-1)
    launch("flash_attention_bwd", "pt_flash_attention_bwd", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
           dv.data_ptr(), *tail, ctypes.byref(design))
    _count(_bwd_stats, _bwd_mask_stats, mask, "kernel")
    _count_design("flash_attention_bwd", mask, design)
    return dq.to(q.dtype), dk, dv


def flash_attention_bwd(q, k, v, out, lse, do, causal: bool = False,
                        scale=None, mask=None):
    """Attention backward: (dq, dk, dv) in q's type, from the forward's
    ``out`` and ``lse``, the output gradient ``do`` and the forward's
    mask: the one-pass backward while Lq * D * 4 bytes fit the gate, the
    split pair above it. delta is formed once, for either."""
    if out.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} "
                         f"against q {tuple(q.shape)}")
    delta = attention_delta(out, do)
    if not uses_split_bwd(q.shape[1], q.shape[-1]):
        return flash_attention_bwd_fused(q, k, v, lse, delta, do, causal,
                                         scale, mask)
    return (flash_attention_bwd_dq(q, k, v, lse, delta, do, causal, scale,
                                   mask),
            *flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal, scale,
                                     mask))


class FlashAttentionFunction(torch.autograd.Function):
    """Attention (causal or not, with or without a bool mask) through the
    flash kernels: the forward saves ``out``, ``lse`` and the mask, the
    backward recomputes P from them. The mask gets no gradient (None), as
    the reference's vjp gives a bool mask a float0 one (l.1146-1153)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal, scale, mask)
        ctx.save_for_backward(q, k, v, out, lse, mask)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, mask = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal,
                                         ctx.scale, mask)
        return dq, dk, dv, None, None, None


_NEG = -1e30


def attention_composition(q, k, v, mask=None, causal: bool = False,
                          scale=None, dropout_p: float = 0.0,
                          generator=None):
    """Attention as plain tensor ops, with a bool or additive mask and
    dropout on the attention weights (port of ``flash_attention_xla``,
    computed in fp32). A row with every position masked gives 0."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * scale
    valid = None
    if causal:
        cmask = torch.ones(Lq, Lk, dtype=torch.bool, device=q.device).tril(
            diagonal=Lk - Lq)
        s = torch.where(cmask, s, _NEG)
        valid = cmask.expand_as(s)
    if mask is not None:
        if mask.dtype == torch.bool:
            s = torch.where(mask, s, _NEG)
            mvalid = mask.expand_as(s)
        else:
            s = s + mask.float().clamp_min(_NEG)
            mvalid = (mask.float() > _NEG).expand_as(s)
        valid = mvalid if valid is None else (valid & mvalid)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    probs = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if valid is not None:
        probs = torch.where(valid.any(dim=-1, keepdim=True), probs, 0.0)
    if dropout_p > 0.0:
        keep = _random.rand(probs.shape, generator,
                            probs.device) >= dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0)
    return torch.einsum("bhlm,bmhd->blhd", probs, v.float()).to(q.dtype)


@checked("flash_attention")
def flash_attention(q, k, v, mask=None, causal: bool = False, scale=None,
                    dropout_p: float = 0.0, generator=None):
    """Dispatch (counterpart of ``paddle_tpu``'s ``flash_attention``):
    the flash kernels (their plain versions on the CPU) for attention
    they take, unmasked or with a bool mask that ``mask_takes``;
    ``attention_composition``, counted in ``composed_stats``, for
    dropout > 0 (weight dropout needs the normalised probabilities, which
    the online softmax never forms), for any other mask (a float mask's
    gradient is real), and on a card for whatever ``kernel_takes``
    refuses. A mask the kernels take launches them or raises: there is
    no way round to the composition."""
    takes = (kernel_takes(q, k, v, mask, causal) if use_kernel(q)
             else mask_takes(q, k, mask))
    if dropout_p > 0.0 or not takes:
        count_composed("flash_attention")
        return attention_composition(q, k, v, mask, causal, scale,
                                     dropout_p, generator)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttentionFunction.apply(q, k, v, mask, bool(causal),
                                        float(scale))
