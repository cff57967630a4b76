"""Paged KV-cache decode attention: CUDA kernel ``csrc/paged_attention.cu``,
its plain PyTorch version, and the in-place cache updates.

Replaces ``paddle_tpu/ops/pallas/paged_attention.py:_paged_attn_pallas``.
The kernel is bound by bytes. It splits each sequence's context into
partitions of ``PART_TOKENS`` tokens (flash-decoding; ``partitions`` is
the arithmetic, a function of the block table's width and the page size
alone, so the host never reads ``context_lens``): one block per (head,
sequence, partition) reads only the live pages of its partition, with
16-byte loads and many tokens in flight, and writes a partial softmax
state (acc, m, l) to an fp32 workspace; a second kernel merges the
partitions in a fixed order. Pages past ``ceil(ctx / page_size)`` are
never read, ctx == 0 gives exactly 0, and runs repeat bit for bit.
``paged_attention_split_plain`` renders the same split and merge in
PyTorch. See the source.

Layout (paddle): q is [batch, heads, head_dim] (one decode token per
sequence); pools are [num_pages, page_size, heads, head_dim]; page 0 is
the null page, which idle slots point at and masked writes land on.

``cache_append``, ``prefill_append`` and ``cow_copy_pages`` port the XLA
scatters of the reference (l.450-539). JAX updates are functional with
the pools donated; here they write the pools in place. JAX also clamps
an out-of-range gather and drops an out-of-range scatter without a word,
where CUDA indexing faults, so each of them states its index rule.
"""
from __future__ import annotations

import math

import torch

from . import launch, same_device, use_kernel

_stats = {"kernel": 0, "plain": 0}

_TYPES = (torch.float32, torch.bfloat16)
_MAX_D = 128
_NEG = -1e30

#: tokens of one partition of a sequence's context (whole pages: at a page
#: above it, one page)
PART_TOKENS = 256


def partitions(pages_per_seq: int, page_size: int) -> tuple[int, int]:
    """(pages a partition, partitions a sequence) of the kernel's split of
    a block-table row of ``pages_per_seq`` pages of ``page_size`` tokens.
    Partition s covers tokens [s * part, (s + 1) * part) with part = pages
    a partition * page_size; the last one may hold fewer pages."""
    part_pages = max(1, PART_TOKENS // page_size)
    return part_pages, -(-pages_per_seq // part_pages)


def kernel_design(k_pages, v_pages, block_tables) -> str:
    """The kernel's split and loads for these pools, as
    ``csrc/paged_attention.cu`` picks them: 16-byte loads when every row
    of both pools starts on a 16-byte boundary, else element loads."""
    page_size, D = k_pages.shape[1], k_pages.shape[-1]
    part_pages, n_parts = partitions(block_tables.shape[1], page_size)
    vec = (k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0
           and (D * k_pages.element_size()) % 16 == 0)
    return (f"{n_parts} partitions x {part_pages * page_size} tokens, "
            f"{'16-byte' if vec else 'element'} loads")


def paged_attention_plain(q, k_pages, v_pages, block_tables, context_lens,
                          scale=None):
    """Dense gather of every block-table page, masked past context_lens,
    softmax in fp32 (port of ``paged_attention_xla``). A sequence with
    ``context_lens == 0`` outputs exactly zero."""
    B, H, D = q.shape
    page_size = k_pages.shape[1]
    n_pages = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    idx = block_tables.long()
    k = k_pages[idx].reshape(B, n_pages * page_size, H, D)
    v = v_pages[idx].reshape(B, n_pages * page_size, H, D)
    s = torch.einsum("bhd,blhd->bhl", q.float(), k.float()) * scale
    pos = torch.arange(n_pages * page_size, device=q.device)[None, None, :]
    live = pos < context_lens.to(q.device)[:, None, None]
    s = torch.where(live, s, _NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(live, p, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhl,blhd->bhd", p / l, v.float())
    return out.to(q.dtype)


def paged_attention_split_plain(q, k_pages, v_pages, block_tables,
                                context_lens, scale=None):
    """The kernel's arithmetic in PyTorch, fp32: per partition of
    ``partitions`` the state (acc = sum of exp(s - m) v, m, l = sum of
    exp(s - m)) over its live tokens, m = -inf and l = 0 for a partition
    with none; then the merge in partition order, each live state scaled
    by exp(m_s - max m); ctx == 0 gives exactly 0."""
    B, H, D = q.shape
    page_size = k_pages.shape[1]
    pps = block_tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    part_pages, n_parts = partitions(pps, page_size)
    part = part_pages * page_size
    ctx = context_lens.long().clamp(0, pps * page_size)
    out = torch.zeros(B, H, D, dtype=torch.float32, device=q.device)
    for b in range(B):
        n = int(ctx[b])
        states = []
        for s in range(n_parts):
            t0, t1 = s * part, min(n, (s + 1) * part)
            if t1 <= t0:
                states.append((None, float("-inf"), 0.0))
                continue
            tok = torch.arange(t0, t1, device=q.device)
            pages = block_tables[b].long()[tok // page_size]
            k = k_pages[pages, tok % page_size].float()  # [n, H, D]
            v = v_pages[pages, tok % page_size].float()
            sc = torch.einsum("hd,nhd->hn", q[b].float(), k) * scale
            m = sc.amax(dim=-1, keepdim=True)
            p = torch.exp(sc - m)
            states.append((torch.einsum("hn,nhd->hd", p, v), m,
                           p.sum(dim=-1, keepdim=True)))
        live = [st for st in states if st[0] is not None]
        if not live:
            continue
        mx = torch.stack([st[1] for st in live]).amax(dim=0)
        acc = torch.zeros(H, D, device=q.device)
        lsum = torch.zeros(H, 1, device=q.device)
        for a, m, l in live:
            c = torch.exp(m - mx)
            acc = acc + a * c
            lsum = lsum + l * c
        out[b] = acc / lsum.clamp_min(1e-30)
    return out.to(q.dtype)


def check_args(q, k_pages, v_pages, block_tables, context_lens) -> None:
    """What the CUDA kernel takes; raises ValueError on anything else."""
    same_device("paged_attention", q, k_pages, v_pages, block_tables,
                context_lens)
    if q.dtype not in _TYPES or not (q.dtype == k_pages.dtype
                                     == v_pages.dtype):
        raise ValueError(f"paged_attention: types {q.dtype}/{k_pages.dtype}"
                         f"/{v_pages.dtype}; the kernel takes one of float32 "
                         f"and bfloat16 (float16 is excluded, as on the TPU)")
    if q.dim() != 3 or q.stride(-1) != 1:
        raise ValueError("paged_attention: q must be [B, H, D] with a "
                         "contiguous last dim")
    B, H, D = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape or \
            k_pages.shape[2:] != (H, D):
        raise ValueError(f"paged_attention: pools {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged_attention: pools must be contiguous")
    if D > _MAX_D:
        raise ValueError(f"paged_attention: head dim {D} > {_MAX_D}")
    for name, t, shape in (("block_tables", block_tables,
                            (B, block_tables.shape[-1])),
                           ("context_lens", context_lens, (B,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or \
                not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous "
                             f"int32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if B > 65535:
        raise ValueError("paged_attention: B must be <= 65535")


def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    scale=None):
    """Single-token decode attention over a paged KV pool: q [B, H, D];
    pools [num_pages, page_size, H, D]; block_tables [B, pages_per_seq]
    int32, every slot a valid page id (the serving layer points unused
    slots at the null page 0); context_lens [B] int32. Returns [B, H, D]."""
    B, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if not use_kernel(q):
        _stats["plain"] += 1
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     context_lens, scale)
    check_args(q, k_pages, v_pages, block_tables, context_lens)
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    pps = block_tables.shape[1]
    if B == 0 or pps == 0:
        return out.zero_()
    page_size = k_pages.shape[1]
    part_pages, n_parts = partitions(pps, page_size)
    ws = torch.empty((B, H, n_parts, D + 2), dtype=torch.float32,
                     device=q.device)
    launch("paged_attention", "pt_paged_attention", q.device,
           q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
           block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
           ws.data_ptr(), q.stride(0), q.stride(1), B, H, D, page_size,
           pps, part_pages, n_parts, float(scale),
           int(q.dtype == torch.bfloat16))
    _stats["kernel"] += 1
    return out


# ----------------------------- cache updates ---------------------------------


def cache_append(k_pages, v_pages, k_new, v_new, block_tables, context_lens,
                 active=None):
    """Write k_new/v_new [B, H, D] at position context_lens[b] of each
    active sequence, in place. Inactive rows write to the null page 0 at
    offset 0 (garbage no attention reads), so that index may repeat; which
    of those writes lands is left open, as it is harmless.

    Index rule: the reference gathers the page with ``take_along_axis``,
    whose out-of-range index (a context at or past pages_per_seq *
    page_size) fills, and its scatter then drops the write. Here the
    gather index is clamped and such rows are sent to the null page, which
    has the same effect without an out-of-range access."""
    page_size = k_pages.shape[1]
    pps = block_tables.shape[1]
    ctx = context_lens.long()
    page_idx = ctx // page_size
    live = page_idx < pps
    if active is not None:
        live = live & active
    page = block_tables.gather(1, page_idx.clamp(max=pps - 1)[:, None])[:, 0]
    page = torch.where(live, page.long(), 0)
    off = torch.where(live, ctx % page_size, 0)
    k_pages.index_put_((page, off), k_new.to(k_pages.dtype))
    v_pages.index_put_((page, off), v_new.to(v_pages.dtype))


def prefill_append(k_pages, v_pages, k_seq, v_seq, page_ids, length: int,
                   start: int = 0):
    """Write a prompt's K/V [L, H, D] into ONE sequence's pages, in place:
    position i goes to page_ids[i // page_size] at offset i % page_size,
    for start <= i < length only. Positions at or past ``length`` are
    bucket padding, and positions below ``start`` already live in pages
    forked from another request (copy-on-write prefix sharing), which must
    not be written. The reference scatters those positions to the null
    page; here they are not written at all.

    Index rule: ``length`` must fit the block-table row (the reference's
    gather would clamp and its scatter drop); a longer one raises here,
    on the host, before any device index is formed."""
    page_size = k_pages.shape[1]
    length, start = int(length), int(start)
    if length > page_ids.shape[0] * page_size or length > k_seq.shape[0]:
        raise ValueError(f"prefill_append: length {length} exceeds the "
                         f"block-table row or the sequence")
    if start >= length:
        return
    pos = torch.arange(start, length, device=k_pages.device)
    pages = page_ids.to(k_pages.device)[pos // page_size].long()
    offs = pos % page_size
    k_pages.index_put_((pages, offs), k_seq[start:length].to(k_pages.dtype))
    v_pages.index_put_((pages, offs), v_seq[start:length].to(v_pages.dtype))


def cow_copy_pages(k_pages, v_pages, src: int, dst: int):
    """Copy-on-write fork of ONE pool page: page ``src`` is copied into
    ``dst`` in every layer's K and V pool, in place. The page ids come from
    the allocator on the host, so they are checked there."""
    n = k_pages[0].shape[0]
    if not (0 <= src < n and 0 <= dst < n):
        raise ValueError(f"cow_copy_pages: pages {src}, {dst} outside "
                         f"[0, {n})")
    for pool in (*k_pages, *v_pages):
        pool[dst].copy_(pool[src])
