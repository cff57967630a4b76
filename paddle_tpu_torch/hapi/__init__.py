"""paddle_tpu_torch.hapi — the high-level training API (counterpart of
``paddle_tpu/hapi``)."""
from . import callbacks  # noqa: F401
from .model import Model  # noqa: F401

__all__ = ["Model", "callbacks"]
