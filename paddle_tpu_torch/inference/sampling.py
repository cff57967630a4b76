"""Sampling policies for the serving decode step (counterpart of
``paddle_tpu/inference/sampling.py``).

Determinism contract (the property the engine's recompute-style
preemption relies on):

* every request carries its own integer ``seed`` (defaulting to its
  request id), passed per lane in ``seeds``; no RNG state is carried
  between iterations;
* the n-th sampled token of a request draws from a ``torch.Generator``
  seeded with ``fold_seed(seed, n)``, a fixed function of (seed, n), so a
  request preempted after k tokens and re-prefilled resumes sampling
  token k with exactly the generator it would have used uninterrupted;
* ``temperature == 0`` lanes take the exact ``argmax`` (the first maximum,
  as in JAX) and are bit-identical to ``GPT.generate_paged``.

PyTorch's generators do not reproduce JAX's ``fold_in`` bits, so sampled
(non-greedy) tokens differ from the reference's; greedy tokens match.
When every lane is greedy the sampling branch is skipped.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["SamplingParams", "sample_logits", "fold_seed"]

#: lanes with temperature <= _GREEDY_EPS are greedy (exact argmax);
#: positive temperatures below it are clamped to it for stable division
_GREEDY_EPS = 1e-6

_MASK64 = (1 << 64) - 1


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
    """The generator seed of a request's `step`-th token: splitmix64 of
    (seed, step), a pure function of the two."""
    z = (((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFF


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


def sample_logits(logits, temperature, top_k, top_p, seeds, steps):
    """Draw one token per lane from `logits` [B, V]. The policy args are
    per-lane sequences of length B: `temperature`, `top_k`, `top_p`,
    `seeds` and `steps` (tokens already sampled by that lane's request).
    Returns [B] int32 on the logits' device."""
    logits = logits.float()
    dev = logits.device
    greedy = logits.argmax(dim=-1).to(torch.int32)
    temperature = torch.as_tensor(temperature, dtype=torch.float32)
    is_greedy = temperature <= _GREEDY_EPS
    if bool(is_greedy.all()):
        return greedy
    scaled = logits / temperature.clamp_min(_GREEDY_EPS).to(dev)[:, None]
    masked = _truncate(scaled, torch.as_tensor(top_k, device=dev),
                       torch.as_tensor(top_p, dtype=torch.float32,
                                       device=dev))
    probs = torch.softmax(masked, dim=-1)
    out = greedy.clone()
    for i in torch.nonzero(~is_greedy).flatten().tolist():
        gen = torch.Generator(device=dev)
        gen.manual_seed(fold_seed(int(seeds[i]), int(steps[i])))
        out[i] = torch.multinomial(probs[i], 1, generator=gen)[0].to(
            torch.int32)
    return out
