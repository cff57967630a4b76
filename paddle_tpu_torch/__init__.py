"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for the NVIDIA H100.

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
module paths (``models/gpt.py``, ``inference/serving.py``, ...) so each
module's counterpart is easy to find, and it imports neither JAX nor
anything of ``paddle_tpu``. Every Pallas kernel on a ported path is a
hand-written CUDA kernel for ``sm_90a`` under ``csrc/``, with a plain
PyTorch version beside its wrapper in ``ops/kernels/``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from .framework.flags import get_flags, set_flags
from .framework.io import load, save
from .framework.random import seed

__all__ = ["get_flags", "load", "save", "seed", "set_flags"]
