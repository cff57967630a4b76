"""Sampling policies for the serving decode step (counterpart of
``paddle_tpu/inference/sampling.py``).

Determinism contract (the property the engine's recompute-style
preemption relies on):

* every request carries its own integer ``seed`` (defaulting to its
  request id), passed per lane in ``seeds``; no RNG state is carried
  between iterations;
* the n-th sampled token of a request draws with the key
  ``fold_seed(seed, n)``, a fixed function of (seed, n), so a request
  preempted after k tokens and re-prefilled resumes sampling token k with
  exactly the key it would have used uninterrupted;
* ``temperature == 0`` lanes take the exact ``argmax`` (the first maximum,
  as in JAX) and are bit-identical to ``GPT.generate_paged``.

The draw is a pure function of device tensors, so it runs inside a
captured CUDA graph: the key is computed on the device from ``seeds`` and
``steps`` (``fold_seed_tensor``, equal bit for bit to :func:`fold_seed`),
each column gets a uniform from a counter-based hash of (key, column), and
the token is the Gumbel-max ``argmax(logits' + G)`` over the truncated,
temperature-scaled logits, which draws exactly from their softmax. These
are not JAX's ``fold_in`` bits, so sampled (non-greedy) tokens differ from
the reference's; greedy tokens match.

When every lane is greedy the sampling branch is skipped (the reference's
``lax.cond``). Temperatures are host data, so that choice is made on the
host before the step (``sampled=``) and picks one of two step variants.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["SamplingParams", "sample_logits", "fold_seed",
           "fold_seed_tensor", "any_sampled"]

#: lanes with temperature <= _GREEDY_EPS are greedy (exact argmax);
#: positive temperatures below it are clamped to it for stable division
_GREEDY_EPS = 1e-6

_MASK64 = (1 << 64) - 1
#: splitmix64's Weyl increment and multipliers
_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling policy.

    temperature: 0 (default) = greedy argmax; > 0 scales logits by
        1/temperature before the draw.
    top_k: keep only the k highest logits (0 = disabled).
    top_p: nucleus sampling — keep the smallest set of tokens whose
        probability mass reaches top_p (1.0 = disabled). The highest-
        probability token is always kept.
    seed: RNG seed for this request; None derives it from the request
        id at submit. The n-th token draws with fold_seed(seed, n).
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 disables), "
                             f"got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= _GREEDY_EPS


def fold_seed(seed: int, step: int) -> int:
    """The key of a request's `step`-th token: splitmix64 of (seed, step),
    a pure function of the two."""
    z = (((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))
    z = (z + _GOLDEN) & _MASK64
    z = ((z ^ (z >> 30)) * _MIX1) & _MASK64
    z = ((z ^ (z >> 27)) * _MIX2) & _MASK64
    return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFF


def _signed(c: int) -> int:
    """A 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _lshr(z, s: int):
    """Logical right shift of an int64 tensor: ``>>`` on a signed tensor
    is arithmetic, so the sign bits it shifts in are masked off."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix(z):
    """splitmix64's finaliser on int64 tensors (products wrap mod 2**64)."""
    z = (z ^ _lshr(z, 30)) * _signed(_MIX1)
    z = (z ^ _lshr(z, 27)) * _signed(_MIX2)
    return z ^ _lshr(z, 31)


def fold_seed_tensor(seeds, steps):
    """:func:`fold_seed` of int64 tensors of seeds and steps, elementwise,
    on their device: the same bits as the host function."""
    z = ((seeds & 0xFFFFFFFF) << 32) | (steps & 0xFFFFFFFF)
    return _mix(z + _signed(_GOLDEN)) & 0x7FFFFFFFFFFFFFFF


def _gumbel(keys, V: int):
    """[B, V] standard Gumbel noise, column j of lane b a pure function of
    (keys[b], j): the top 23 bits of splitmix64 of the key's j+1-th
    Weyl step give u = (bits + 0.5) / 2**23, exactly in (0, 1) in fp32,
    and G = -log(-log(u)), finite."""
    col = torch.arange(1, V + 1, dtype=torch.int64, device=keys.device)
    bits = _lshr(_mix(keys[:, None] + col[None, :] * _signed(_GOLDEN)), 41)
    u = (bits.to(torch.float32) + 0.5) * (2.0 ** -23)
    return -torch.log(-torch.log(u))


def _truncate(logits, top_k, top_p):
    """Mask logits outside the per-lane top-k/top-p sets to -inf.
    `logits` [B, V] f32; `top_k` [B] int (0 = off); `top_p` [B] f32
    (1 = off). Value-threshold mapping back from the sorted order keeps
    ties together (deterministically over-inclusive, never empty)."""
    V = logits.shape[-1]
    desc = torch.sort(logits, dim=-1, descending=True).values   # [B, V]
    # top-k: threshold at the k-th largest value (k<=0 -> keep all)
    k = top_k.clamp(0, V)
    kth = desc.gather(-1, (k - 1).clamp_min(0)[:, None].long())  # [B, 1]
    keep_k = torch.where((k > 0)[:, None], logits >= kth, True)
    # top-p: keep sorted tokens whose PRECEDING cumulative mass < p
    # (the top token's preceding mass is 0, so it always survives)
    probs = torch.exp(desc - desc[:, :1])
    probs = probs / probs.sum(dim=-1, keepdim=True)
    before = torch.cumsum(probs, dim=-1) - probs                 # mass before i
    kept_sorted = before < top_p[:, None]
    # smallest kept sorted value = the admission threshold per lane
    thresh = torch.where(kept_sorted, desc, float("inf")).amin(
        dim=-1, keepdim=True)
    keep_p = logits >= thresh
    return torch.where(keep_k & keep_p, logits, float("-inf"))


def any_sampled(temperature) -> bool:
    """The host's choice of step variant: True when some lane samples
    (temperature above the greedy threshold)."""
    if isinstance(temperature, torch.Tensor):
        temperature = temperature.cpu().numpy()
    return bool((np.asarray(temperature, np.float32) > _GREEDY_EPS).any())


def sample_logits(logits, temperature, top_k, top_p, seeds, steps,
                  sampled: Optional[bool] = None):
    """Draw one token per lane from `logits` [B, V]. The policy args are
    per-lane sequences or tensors of length B: `temperature`, `top_k`,
    `top_p`, `seeds` and `steps` (tokens already sampled by that lane's
    request). `sampled` False returns the argmax of every lane (the
    all-greedy variant); None decides it from `temperature` on the host
    (:func:`any_sampled`). Returns [B] int32 on the logits' device; given
    device tensors and `sampled`, it reads nothing back to the host."""
    logits = logits.float()
    dev = logits.device
    greedy = logits.argmax(dim=-1).to(torch.int32)
    if sampled is None:
        sampled = any_sampled(temperature)
    if not sampled:
        return greedy
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=dev)
    scaled = logits / temperature.clamp_min(_GREEDY_EPS)[:, None]
    masked = _truncate(scaled, torch.as_tensor(top_k, device=dev),
                       torch.as_tensor(top_p, dtype=torch.float32,
                                       device=dev))
    keys = fold_seed_tensor(
        torch.as_tensor(seeds, dtype=torch.int64, device=dev),
        torch.as_tensor(steps, dtype=torch.int64, device=dev))
    drawn = (masked + _gumbel(keys, logits.shape[-1])).argmax(dim=-1)
    return torch.where(temperature <= _GREEDY_EPS, greedy,
                       drawn.to(torch.int32))
