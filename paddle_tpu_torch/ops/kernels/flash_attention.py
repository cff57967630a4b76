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

Designs (``kernel_design``): bf16 at head dim 64 or 128 with 16-byte
aligned rows runs the forward, the one-pass backward and the split
backward pair on the tensor cores (``mma.sync`` m16n8k16, fp32
accumulators, P and dS rounded to bf16 before the products that read
them, as the reference does); fp32, other head dims and unaligned rows
run on CUDA cores.

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

``FlashAttentionFunction`` is the counterpart of the ``jax.custom_vjp`` at
l.1118-1155: one Function on both devices, whose forward and backward
launch the kernels for CUDA tensors and run the plain versions for CPU
ones.

Layout convention (paddle): q/k/v are [batch, seq, heads, head_dim].
"""
from __future__ import annotations

import math

import torch

from . import count_composed, launch, same_device, use_kernel

_stats = {"kernel": 0, "plain": 0}
#: launches of the one-pass backward kernel (and runs of its plain version)
_bwd_stats = {"kernel": 0, "plain": 0}
#: launches of the split backward's dq and dk/dv kernels (and plain runs)
_bwd_dq_stats = {"kernel": 0, "plain": 0}
_bwd_dkv_stats = {"kernel": 0, "plain": 0}

#: the one-pass backward's whole-(b, h) dq bound (reference l.955): above
#: it, Lq * D * 4 bytes, the split pair runs
_FUSED_BWD_DQ_BYTES = 6 * 1024 * 1024

_TYPES = (torch.float32, torch.bfloat16)
_MAX_D = 128


def flash_attention_plain(q, k, v, causal: bool = False, scale=None):
    """(out [B, Lq, H, D] in q's type, lse [B, H, Lq] fp32), in fp32.
    Causal masking uses kv_offset = Lk - Lq; a row with no visible key
    gives out 0 and lse -inf."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones(Lq, Lk, dtype=torch.bool, device=q.device).tril(
            diagonal=Lk - Lq)
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


def kernel_takes(q, k, v, mask=None, causal: bool = False) -> bool:
    """Whether the flash kernels take this attention on a card: the
    counterpart of the reference's ``_pallas_eligible`` (l.1217-1253).
    False, and ``flash_attention`` composes, for fp16 or fp64 (or mixed)
    types, causal with Lq > Lk (rows with no visible key), a head dim
    above 128 or not a multiple of 8 (the reference's compile probe,
    ``_pallas_fa_ok``, fails there), a float mask (its gradient is real)
    and a bool mask (no kernel streams masks yet)."""
    if mask is not None:
        return False
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _TYPES:
        return False
    D = q.shape[-1]
    if D > _MAX_D or D % 8:
        return False
    return not (causal and q.shape[1] > k.shape[1])


def kernel_design(*tensors) -> str:
    """The design the forward and backward launchers (one-pass and split)
    pick for these [B, L, H, D] inputs (q first; the backward's dO too),
    as ``csrc/flash_attention.cu`` and
    ``csrc/flash_attention_bwd.cuh:tc_takes`` pick it: "mma.sync" for bf16
    at D 64 or 128 with every row 16-byte aligned, else "cuda-core"."""
    q = tensors[0]
    aligned = all(t.data_ptr() % 16 == 0
                  and all(st % 8 == 0 for st in t.stride()[:3])
                  for t in tensors)
    tc = q.dtype == torch.bfloat16 and q.shape[-1] in (64, 128)
    return "mma.sync" if tc and aligned else "cuda-core"


def flash_attention_fwd(q, k, v, causal: bool = False, scale=None):
    """Attention forward: (out [B, Lq, H, D], lse [B, H, Lq] fp32)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not use_kernel(q):
        _stats["plain"] += 1
        return flash_attention_plain(q, k, v, causal, scale)
    check_args(q, k, v, causal)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    launch("flash_attention", "pt_flash_attention_fwd", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           lse.data_ptr(), *q.stride()[:3], *k.stride()[:3],
           *v.stride()[:3], B, H, Lq, Lk, D, int(bool(causal)),
           float(scale), int(q.dtype == torch.bfloat16))
    _stats["kernel"] += 1
    return out, lse


def _p_ds(q, k, v, lse, delta, do, causal, scale):
    """(P, dS) [B, H, Lq, Lk] fp32: P = exp(S * scale - lse) (0 above the
    causal diagonal) and dS = P * (dP - delta), dP = dO V^T."""
    Lq, Lk = q.shape[1], k.shape[1]
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None])
    del s
    if causal:
        keep = torch.ones(Lq, Lk, dtype=torch.bool, device=q.device).tril(
            diagonal=Lk - Lq)
        p = torch.where(keep, p, 0.0)
    dp = torch.einsum("blhd,bmhd->bhlm", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_plain(q, k, v, lse, delta, do, causal: bool = False,
                              scale=None):
    """(dq, dk, dv) in q's type, computed in fp32 from P = exp(S * scale -
    lse) and dS = P * (dP - delta), with delta = rowsum(dO * O) [B, H, Lq]
    fp32 (the TPU kernels' arithmetic)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds = _p_ds(q, k, v, lse, delta, do, causal, scale)
    dv = torch.einsum("bhlm,blhd->bmhd", p, do.float())
    dq = torch.einsum("bhlm,bmhd->blhd", ds, k.float()) * scale
    dk = torch.einsum("bhlm,blhd->bmhd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, lse, delta, do,
                                 causal: bool = False, scale=None):
    """dq = dS K * scale in q's type, computed in fp32 (the split
    backward's dq walk, reference l.282)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _, ds = _p_ds(q, k, v, lse, delta, do, causal, scale)
    return (torch.einsum("bhlm,bmhd->blhd", ds, k.float()) * scale).to(
        q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, lse, delta, do,
                                  causal: bool = False, scale=None):
    """(dk, dv) = (dS^T Q * scale, P^T dO) in k's type, computed in fp32
    (the split backward's dk/dv walk, reference l.353)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds = _p_ds(q, k, v, lse, delta, do, causal, scale)
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


def _bwd_launch_args(q, k, v, lse, delta, do, causal, scale):
    """Checks what the backward kernels take; returns (do, lse, delta)
    ready for them and the strides and sizes every entry takes last."""
    check_args(q, k, v, causal)
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
    tail = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], B, H, Lq, k.shape[1], D, int(bool(causal)),
            float(scale), int(q.dtype == torch.bfloat16))
    return do, lse, delta, tail


def flash_attention_bwd_dq(q, k, v, lse, delta, do, causal: bool = False,
                           scale=None):
    """The split backward's dq [B, Lq, H, D] in q's type: the dq kernel
    for CUDA tensors, its plain version for CPU ones."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not use_kernel(q):
        _bwd_dq_stats["plain"] += 1
        return flash_attention_bwd_dq_plain(q, k, v, lse, delta, do, causal,
                                            scale)
    do, lse, delta, tail = _bwd_launch_args(q, k, v, lse, delta, do, causal,
                                            scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    launch("flash_attention_bwd_dq", "pt_flash_attention_bwd_dq", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *tail)
    _bwd_dq_stats["kernel"] += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal: bool = False,
                            scale=None):
    """The split backward's (dk, dv) [B, Lk, H, D] in k's type: the dk/dv
    kernel for CUDA tensors, its plain version for CPU ones."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not use_kernel(q):
        _bwd_dkv_stats["plain"] += 1
        return flash_attention_bwd_dkv_plain(q, k, v, lse, delta, do, causal,
                                             scale)
    do, lse, delta, tail = _bwd_launch_args(q, k, v, lse, delta, do, causal,
                                            scale)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    launch("flash_attention_bwd_dkv", "pt_flash_attention_bwd_dkv",
           q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
           *tail)
    _bwd_dkv_stats["kernel"] += 1
    return dk, dv


def flash_attention_bwd_fused(q, k, v, lse, delta, do, causal: bool = False,
                              scale=None):
    """The one-pass backward's (dq, dk, dv) in q's type: its kernel for
    CUDA tensors, its plain version for CPU ones."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not use_kernel(q):
        _bwd_stats["plain"] += 1
        return flash_attention_bwd_plain(q, k, v, lse, delta, do, causal,
                                         scale)
    do, lse, delta, tail = _bwd_launch_args(q, k, v, lse, delta, do, causal,
                                            scale)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    launch("flash_attention_bwd", "pt_flash_attention_bwd", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
           dv.data_ptr(), *tail)
    _bwd_stats["kernel"] += 1
    return dq.to(q.dtype), dk, dv


def flash_attention_bwd(q, k, v, out, lse, do, causal: bool = False,
                        scale=None):
    """Attention backward: (dq, dk, dv) in q's type, from the forward's
    ``out`` and ``lse`` and the output gradient ``do``: the one-pass
    backward while Lq * D * 4 bytes fit the gate, the split pair above
    it. delta is formed once, for either."""
    if out.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} "
                         f"against q {tuple(q.shape)}")
    delta = attention_delta(out, do)
    if not uses_split_bwd(q.shape[1], q.shape[-1]):
        return flash_attention_bwd_fused(q, k, v, lse, delta, do, causal,
                                         scale)
    return (flash_attention_bwd_dq(q, k, v, lse, delta, do, causal, scale),
            *flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal, scale))


class FlashAttentionFunction(torch.autograd.Function):
    """Unmasked attention (causal or not) through the flash kernels: the
    forward saves ``out`` and ``lse``, the backward recomputes P from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


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
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) >= dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0)
    return torch.einsum("bhlm,bmhd->blhd", probs, v.float()).to(q.dtype)


def flash_attention(q, k, v, mask=None, causal: bool = False, scale=None,
                    dropout_p: float = 0.0, generator=None):
    """Dispatch (counterpart of ``paddle_tpu``'s ``flash_attention``):
    the flash kernels (their plain versions on the CPU) for unmasked
    attention they take; ``attention_composition``, counted in
    ``composed_stats``, for dropout > 0 (weight dropout needs the
    normalised probabilities, which the online softmax never forms), for
    a mask, and on a card for whatever ``kernel_takes`` refuses."""
    if (dropout_p > 0.0 or mask is not None
            or (use_kernel(q) and not kernel_takes(q, k, v, mask, causal))):
        count_composed("flash_attention")
        return attention_composition(q, k, v, mask, causal, scale,
                                     dropout_p, generator)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttentionFunction.apply(q, k, v, bool(causal), float(scale))
