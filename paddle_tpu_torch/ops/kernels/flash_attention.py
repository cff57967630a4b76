"""Flash-attention forward: CUDA kernel ``csrc/flash_attention.cu``, its
plain PyTorch version, and the dispatch ``flash_attention``.

Replaces the forward kernels of ``paddle_tpu/ops/pallas/flash_attention.py``:
``_fa_fwd_pallas`` (tiled online softmax) and ``_fa_small_fwd_pallas``
(single-shot path for Lq == Lk <= 512). One Hopper kernel covers both. It
is bound by operations at the prefill buckets; it streams 32-key K/V tiles
through shared memory for a 64-row query tile, skips tiles above the causal
diagonal, masks row and column tails (any L >= 1), and reads [B, L, H, D]
through its strides. Outputs are ``out`` in the input type and ``lse``
[B, H, Lq] fp32, which the backward will reuse. See the source for the
design.

Layout convention (paddle): q/k/v are [batch, seq, heads, head_dim].
"""
from __future__ import annotations

import math

import torch

from . import launch, same_device, use_kernel

_stats = {"kernel": 0, "plain": 0}

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
    the flash kernel (or its plain version on the CPU) for unmasked
    attention; the composition for dropout > 0 (weight dropout needs the
    normalised probabilities, which the online softmax never forms), and
    for a mask on the CPU. On a card a mask raises: streaming bool masks
    through the kernel arrives with the BERT slice."""
    if dropout_p > 0.0:
        return attention_composition(q, k, v, mask, causal, scale,
                                     dropout_p, generator)
    if mask is not None:
        if q.device.type == "cuda":
            raise NotImplementedError(
                "flash_attention: attention masks are not ported to the "
                "CUDA kernel yet")
        return attention_composition(q, k, v, mask, causal, scale)
    return flash_attention_fwd(q, k, v, causal, scale)[0]
