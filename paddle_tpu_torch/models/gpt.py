"""GPT — decoder-only transformer LM (counterpart of
``paddle_tpu/models/gpt.py``): GPT-2 style, learned positions, pre-LN
blocks, causal flash attention, logits tied to the token embedding.

The decode path keeps every past token's K/V in fixed-size pages
(``ops/kernels/paged_attention.py``): prefill runs the prompt once through
flash attention while writing its K/V into the pages, and each generated
token is one incremental step that appends one K/V row and attends over
the pages. Where the reference's functional updates returned a new cache,
these methods write the cache's tensors in place and return the same
object, and they run without autograd (the reference's are pure
functions): no graph grows through the cache token by token.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import nn
from .._platform import resolve_device
from ..distributed.fleet.utils import recompute, recompute_policies
from ..nn import functional as F
from ..ops._dispatch import maybe_autocast
from ..ops.kernels import paged_attention as _pa


class PagedKVCache:
    """Paged decode KV cache: per-layer page pools + per-sequence block
    tables (``ops/kernels/paged_attention.py`` layout).

    ``k_pages[l]`` / ``v_pages[l]`` are ``[num_pages, page_size, H, D]``;
    ``block_tables`` is ``[max_batch, pages_per_seq]`` int32 and
    ``context_lens`` ``[max_batch]`` int32, all on the model's device.
    Page 0 is the NULL page: idle batch slots point at it and their
    decode-step writes land there. The tensors are updated in place, so
    one live set exists for the cache's lifetime."""

    def __init__(self, k_pages, v_pages, block_tables, context_lens,
                 page_size: int):
        self.k_pages = list(k_pages)
        self.v_pages = list(v_pages)
        self.block_tables = block_tables
        self.context_lens = context_lens
        self.page_size = int(page_size)

    @property
    def num_pages(self) -> int:
        return self.k_pages[0].shape[0]

    @property
    def pages_per_seq(self) -> int:
        return self.block_tables.shape[1]

    @property
    def max_batch(self) -> int:
        return self.block_tables.shape[0]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    max_position_embeddings: int = 1024
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 0  # 0 => 4*hidden
    dropout: float = 0.1
    attn_dropout: float = 0.1
    tie_word_embeddings: bool = True
    # activation-checkpoint policy per block: "" (keep every activation),
    # "dots" (selective: keep the outputs of the products without batch
    # dims, recompute the rest in the backward), "full" (recompute the
    # whole block)
    remat: str = ""

    def __post_init__(self):
        if not self.intermediate_size:
            self.intermediate_size = 4 * self.hidden_size
        if self.remat not in ("", "dots", "full"):
            raise ValueError(
                f"GPTConfig.remat must be '', 'dots' or 'full', "
                f"got {self.remat!r}")

    @staticmethod
    def gpt2_small():
        return GPTConfig(hidden_size=768, num_layers=12, num_heads=12)

    @staticmethod
    def gpt3_1p3b():
        return GPTConfig(hidden_size=2048, num_layers=24, num_heads=16,
                         max_position_embeddings=2048)

    @staticmethod
    def gpt3_6p7b():
        return GPTConfig(hidden_size=4096, num_layers=32, num_heads=32,
                         max_position_embeddings=2048)

    @staticmethod
    def tiny():
        return GPTConfig(vocab_size=1024, max_position_embeddings=128,
                         hidden_size=64, num_layers=2, num_heads=4,
                         dropout=0.0, attn_dropout=0.0)


def _kw(device, dtype, generator):
    return dict(device=device, dtype=dtype, generator=generator)


class GPTAttention(nn.Layer):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None,
                 generator=None):
        super().__init__(device, dtype)
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.head_dim = h // cfg.num_heads
        self.qkv = nn.Linear(h, 3 * h, **_kw(device, dtype, generator))
        self.proj = nn.Linear(h, h, **_kw(device, dtype, generator))
        self.attn_dropout = cfg.attn_dropout
        self.resid_drop = nn.Dropout(cfg.dropout)

    def split_qkv(self, x):
        """(q, k, v), each a [B, L, H, D] view of one qkv projection."""
        B, L, _ = x.shape
        qkv = self.qkv(x).reshape(B, L, 3, self.num_heads, self.head_dim)
        return qkv.unbind(dim=2)

    def forward(self, x):
        B, L, H = x.shape
        q, k, v = self.split_qkv(x)
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.attn_dropout,
            training=self.training)
        return self.resid_drop(self.proj(out.reshape(B, L, H)))


class GPTMLP(nn.Layer):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None,
                 generator=None):
        super().__init__(device, dtype)
        kw = _kw(device, dtype, generator)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, x):
        return self.drop(self.fc2(F.gelu(self.fc1(x), approximate=True)))


class GPTBlock(nn.Layer):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None,
                 generator=None):
        super().__init__(device, dtype)
        kw = _kw(device, dtype, generator)
        self.ln1 = nn.LayerNorm(cfg.hidden_size, device=device, dtype=dtype)
        self.attn = GPTAttention(cfg, **kw)
        self.ln2 = nn.LayerNorm(cfg.hidden_size, device=device, dtype=dtype)
        self.mlp = GPTMLP(cfg, **kw)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class GPT(nn.Layer):
    """GPT on ``device`` (``cuda`` unless the caller passes ``"cpu"``).
    Weights are drawn from ``generator`` (PyTorch's default CPU generator
    when None, which ``paddle_tpu_torch.seed`` seeds)."""

    def __init__(self, cfg: GPTConfig, device=None, dtype=None,
                 generator=None):
        device = resolve_device(device)
        super().__init__(device, dtype)
        self.cfg = cfg
        kw = _kw(device, dtype, generator)
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.wpe = nn.Embedding(cfg.max_position_embeddings,
                                cfg.hidden_size, **kw)
        self.drop = nn.Dropout(cfg.dropout)
        self.blocks = nn.LayerList([GPTBlock(cfg, **kw)
                                    for _ in range(cfg.num_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size, device=device, dtype=dtype)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias_attr=False, **kw)
        self.name_parameters()

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def embed(self, input_ids, pos):
        return self.wte(input_ids) + self.wpe(pos)

    def logits(self, x):
        x = self.ln_f(x)
        if self.cfg.tie_word_embeddings:
            # the reference's ``matmul`` op: white-listed under autocast
            x, w = maybe_autocast("matmul", x, self.wte.weight)
            return torch.matmul(x, w.t())
        return self.lm_head(x)

    # the pipeline protocol (distributed.meta_parallel.pipeline_parallel):
    # pipeline_pre -> the homogeneous blocks -> pipeline_post
    def pipeline_pre(self, input_ids):
        """The embeddings of ``input_ids`` (after dropout): the blocks'
        input."""
        L = input_ids.shape[1]
        pos = torch.arange(L, device=input_ids.device)
        return self.drop(self.embed(input_ids, pos))

    def pipeline_post(self, x):
        """The logits of the blocks' output ``x``."""
        return self.logits(x)

    def forward(self, input_ids):
        x = self.pipeline_pre(input_ids)
        if self.cfg.remat and self.training:
            pol = (None if self.cfg.remat == "full"
                   else recompute_policies.dots)
            for blk in self.blocks:
                x = recompute(blk, x, policy=pol)
        else:
            for blk in self.blocks:
                x = blk(x)
        return self.pipeline_post(x)

    def loss(self, input_ids, labels):
        """Mean next-token cross-entropy of ``labels`` under the logits of
        ``input_ids`` (labels of ``ignore_index`` -100 are skipped)."""
        return F.cross_entropy(self(input_ids), labels)

    # ---------------- autoregressive decode (paged KV cache) ----------------

    def init_cache(self, max_batch: int, max_len: int, page_size: int = 16,
                   num_pages: int = 0, dtype=None) -> PagedKVCache:
        """An empty paged KV cache for `max_batch` concurrent sequences of
        up to `max_len` tokens. `num_pages` defaults to full backing (every
        slot can reach max_len) plus the null page."""
        if max_len > self.cfg.max_position_embeddings:
            raise ValueError(
                f"init_cache: max_len {max_len} exceeds "
                f"max_position_embeddings {self.cfg.max_position_embeddings}")
        pages_per_seq = -(-max_len // page_size)
        if not num_pages:
            num_pages = 1 + max_batch * pages_per_seq  # +1: the null page
        dtype = dtype or self.wte.weight.dtype
        H = self.cfg.num_heads
        D = self.cfg.hidden_size // H
        shape = (num_pages, page_size, H, D)
        dev = self.device
        k_pages = [torch.zeros(shape, dtype=dtype, device=dev)
                   for _ in self.blocks]
        v_pages = [torch.zeros(shape, dtype=dtype, device=dev)
                   for _ in self.blocks]
        bt = torch.zeros((max_batch, pages_per_seq), dtype=torch.int32,
                         device=dev)
        cl = torch.zeros((max_batch,), dtype=torch.int32, device=dev)
        return PagedKVCache(k_pages, v_pages, bt, cl, page_size)

    @torch.no_grad()
    def forward_prefill(self, input_ids, cache: PagedKVCache, slot,
                        length, write_start=0):
        """Prefill ONE sequence: run the prompt through causal flash
        attention while writing every position's K/V into the pages of
        batch slot `slot`. `input_ids` is [1, L_bucket] (padded up to a
        shape bucket); `length` is the real prompt length. Positions below
        `write_start` already live in pages shared with another request
        (copy-on-write prefix) and are not written; attention still runs
        over the whole prompt. Returns (last-position logits [1, V], cache),
        the cache updated in place.

        `slot`, `length` and `write_start` are Python ints, or 0-d device
        tensors: then nothing reads a host value (a captured prefill
        replays with other ones), the last real position is gathered on
        the device, and the caller checks 1 <= length <= L_bucket."""
        B, L = input_ids.shape
        if B != 1:
            raise ValueError(f"forward_prefill fills ONE slot's pages; got "
                             f"batch {B} (serving prefills per request)")
        on_device = any(isinstance(a, torch.Tensor)
                        for a in (slot, length, write_start))
        if on_device:
            dev = input_ids.device
            slot, length, write_start = (
                torch.as_tensor(a, device=dev).reshape(1)
                for a in (slot, length, write_start))
            page_row = cache.block_tables.index_select(0, slot)[0]
        else:
            slot, length = int(slot), int(length)
            if not 1 <= length <= L:
                raise ValueError(f"forward_prefill: length {length} outside "
                                 f"[1, {L}]")
            page_row = cache.block_tables[slot]
        pos = torch.arange(L, device=input_ids.device)
        x = self.embed(input_ids, pos)
        for li, blk in enumerate(self.blocks):
            q, k, v = blk.attn.split_qkv(blk.ln1(x))
            _pa.prefill_append(cache.k_pages[li], cache.v_pages[li], k[0],
                               v[0], page_row, length, start=write_start)
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                 training=False)
            x = x + blk.attn.proj(out.reshape(B, L, self.cfg.hidden_size))
            x = x + blk.mlp(blk.ln2(x))
        # logits of the LAST REAL position only (bucket padding past
        # `length` attends causally to junk and is never read)
        if on_device:
            cache.context_lens.index_copy_(
                0, slot, length.to(cache.context_lens.dtype))
            last = x.index_select(1, length - 1)[:, 0]
        else:
            cache.context_lens[slot] = length
            last = x[:, length - 1]
        return self.logits(last), cache

    @torch.no_grad()
    def forward_decode(self, tokens, cache: PagedKVCache, active=None,
                       slot_map=None):
        """ONE incremental decode step: append each sequence's new token
        K/V to its pages and attend over the paged context. `tokens` is [B]
        (the token at position context_lens[b]); `active` [B] bool masks
        idle slots (their writes land on the null page, their logits are
        garbage nobody reads). Returns (logits [B, V], cache), the cache
        updated in place.

        `slot_map` [W] switches to LANE mode: lane i computes the step for
        cache slot slot_map[i]. Padding lanes carry slot_map[i] >=
        max_batch; `tokens`/`active` are then per lane."""
        dev = self.device
        lanes = slot_map is not None
        if lanes:
            slot_map = torch.as_tensor(slot_map, device=dev).long()
            # The reference gathers with take(mode="clip"); torch indexing
            # would fault on a sentinel, so the index is clamped here. A
            # padding lane reads some real slot's row, but its active flag
            # parks its write on the null page and zeroes its context.
            idx = slot_map.clamp(0, cache.max_batch - 1)
            bt = cache.block_tables[idx]
            ctx = cache.context_lens[idx]
            real = slot_map < cache.max_batch
            active = real if active is None else \
                torch.as_tensor(active, device=dev) & real
        else:
            bt = cache.block_tables
            ctx = cache.context_lens.clone()
            active = (torch.ones(cache.max_batch, dtype=torch.bool,
                                 device=dev) if active is None
                      else torch.as_tensor(active, device=dev))
        tokens = torch.as_tensor(tokens, device=dev)
        # position of the incoming token = current context length
        pos = ctx.clamp(max=self.cfg.max_position_embeddings - 1)
        x = self.embed(tokens, pos)[:, None, :]        # [B, 1, hidden]
        B = x.shape[0]
        # the new token is part of its own context
        attn_lens = torch.where(active, ctx + 1, 0).to(torch.int32)
        for li, blk in enumerate(self.blocks):
            q, k, v = blk.attn.split_qkv(blk.ln1(x))   # [B, 1, H, D]
            _pa.cache_append(cache.k_pages[li], cache.v_pages[li],
                             k[:, 0], v[:, 0], bt, ctx, active)
            out = _pa.paged_attention(q[:, 0], cache.k_pages[li],
                                      cache.v_pages[li], bt, attn_lens)
            x = x + blk.attn.proj(out.reshape(B, 1, self.cfg.hidden_size))
            x = x + blk.mlp(blk.ln2(x))
        if lanes:
            # The reference's scatter-back is .at[slot_map].add(mode="drop"):
            # sentinel lanes (>= max_batch) drop. Here they add 0 at the
            # clamped index instead, which leaves every counter unchanged
            # without an out-of-range write.
            cache.context_lens.index_add_(0, idx, active.to(torch.int32))
        else:
            cache.context_lens.copy_(torch.where(active, ctx + 1, ctx))
        return self.logits(x[:, 0]), cache

    # -- reference decode loops (parity tests) --------------------------------

    @torch.no_grad()
    def generate_dense(self, input_ids, max_new_tokens: int,
                       eos_id: int = -1):
        """Cacheless greedy decode: every token re-runs the FULL forward.
        Returns [B, L + max_new_tokens] (stops early only when every row
        hit eos_id)."""
        ids = input_ids
        for _ in range(max_new_tokens):
            nxt = self(ids)[:, -1].argmax(dim=-1).to(ids.dtype)
            ids = torch.cat([ids, nxt[:, None]], dim=1)
            if eos_id >= 0 and bool((nxt == eos_id).all()):
                break
        return ids

    @torch.no_grad()
    def generate_paged(self, input_ids, max_new_tokens: int,
                       eos_id: int = -1, page_size: int = 8):
        """Greedy decode through the paged path: prefill once per row, then
        one `forward_decode` per token. Row b owns pages
        [1 + b*pps, 1 + (b+1)*pps)."""
        if max_new_tokens <= 0:
            return input_ids
        B, L = input_ids.shape
        cache = self.init_cache(B, L + max_new_tokens, page_size=page_size)
        pps = cache.pages_per_seq
        cache.block_tables.copy_(1 + torch.arange(
            B * pps, dtype=torch.int32, device=self.device).reshape(B, pps))
        last = torch.cat([self.forward_prefill(input_ids[b:b + 1], cache, b,
                                               L)[0] for b in range(B)])
        nxt = last.argmax(dim=-1).to(input_ids.dtype)
        ids = torch.cat([input_ids, nxt[:, None]], dim=1)
        for _ in range(max_new_tokens - 1):
            if eos_id >= 0 and bool((nxt == eos_id).all()):
                break
            logits, _ = self.forward_decode(nxt, cache)
            nxt = logits.argmax(dim=-1).to(input_ids.dtype)
            ids = torch.cat([ids, nxt[:, None]], dim=1)
        return ids
