"""Seeding (counterpart of ``paddle_tpu/framework/random.py``).

The JAX package keeps a process-global key; PyTorch keeps its own
default generators. ``seed`` seeds those, and code that needs a stream
of its own takes an explicit ``torch.Generator``. The two frameworks
draw different numbers from the same seed, so parity tests make their
inputs with numpy and hand them to both."""
from __future__ import annotations

import torch


def seed(s: int) -> torch.Generator:
    """Seed PyTorch's default generators (CPU and every card); returns the
    CPU default generator, which parameter initialisation draws from when
    no generator is passed."""
    return torch.manual_seed(int(s))
