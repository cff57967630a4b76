"""Seeding and the RNG state (counterpart of
``paddle_tpu/framework/random.py``).

The JAX package keeps a process-global key; PyTorch keeps its own
default generators. ``seed`` seeds those, and code that needs a stream
of its own takes an explicit ``torch.Generator``. The two frameworks
draw different numbers from the same seed, so parity tests make their
inputs with numpy and hand them to both.

``get_rng_state``/``set_rng_state`` carry the state a resumed run needs:
PyTorch's CPU generator, every visible card's generator and numpy's
global generator (the samplers shuffle with it), packed as one uint8
array under a magic prefix, so that a checkpoint's ``rng`` leaf stays a
plain numpy array. A leaf without the prefix comes from the JAX
package (its PRNG key): it cannot seed these generators, so
``set_rng_state`` leaves them as they are, warns, and returns False.

``rand`` draws the port's dropout masks. Inside ``generators_drawn()``
it notes every explicit generator it was given, so that a step captured
into a CUDA graph (``jit.graphs``) can register them with the graph.
"""
from __future__ import annotations

import contextlib
import pickle
import warnings

import numpy as np
import torch

_MAGIC = b"PTTORCHRNG1\x00"


def seed(s: int) -> torch.Generator:
    """Seed PyTorch's default generators (CPU and every card); returns the
    CPU default generator, which parameter initialisation draws from when
    no generator is passed."""
    return torch.manual_seed(int(s))


def get_rng_state() -> np.ndarray:
    """The RNG state as a uint8 array (see the module docstring)."""
    state = {"torch": torch.get_rng_state().numpy().tobytes(),
             "cuda": ([s.numpy().tobytes()
                       for s in torch.cuda.get_rng_state_all()]
                      if torch.cuda.is_available() else []),
             "numpy": np.random.get_state()}
    payload = _MAGIC + pickle.dumps(state, protocol=4)
    return np.frombuffer(payload, dtype=np.uint8).copy()


def _bytes_tensor(b: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(b, dtype=np.uint8).copy())


def set_rng_state(state) -> bool:
    """Restore what :func:`get_rng_state` returned; a foreign state (the
    JAX package's key) is left alone with a warning. Returns whether the
    state was applied."""
    from .io import _loads
    arr = state.numpy() if isinstance(state, torch.Tensor) \
        else np.asarray(state)
    raw = arr.tobytes() if arr.dtype == np.uint8 else b""
    if not raw.startswith(_MAGIC):
        warnings.warn(
            f"rng state of dtype {arr.dtype} and shape {arr.shape} was not "
            f"written by paddle_tpu_torch (a JAX PRNG key cannot seed "
            f"PyTorch's generators); the generators are left as they are")
        return False
    st = _loads(raw[len(_MAGIC):])
    torch.set_rng_state(_bytes_tensor(st["torch"]))
    if st["cuda"] and torch.cuda.is_available():
        n = min(len(st["cuda"]), torch.cuda.device_count())
        for i in range(n):
            torch.cuda.set_rng_state(_bytes_tensor(st["cuda"][i]), i)
    np.random.set_state(st["numpy"])
    return True


#: the explicit generators ``rand`` was given inside the innermost
#: ``generators_drawn()`` (None outside one)
_drawn = None


def rand(shape, generator=None, device=None) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator`` (None: the device's default
    generator) on ``device``."""
    if generator is not None and _drawn is not None and not any(
            g is generator for g in _drawn):
        _drawn.append(generator)
    return torch.rand(shape, generator=generator, device=device)


@contextlib.contextmanager
def generators_drawn():
    """Yield a list that collects the explicit generators ``rand`` draws
    from inside the block."""
    global _drawn
    prev, _drawn = _drawn, []
    try:
        yield _drawn
    finally:
        _drawn = prev


__all__ = ["seed", "get_rng_state", "set_rng_state", "rand",
           "generators_drawn"]
