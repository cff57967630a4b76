"""The subset of ``paddle_tpu.framework`` the serving slice needs."""
from .dtype import convert_dtype
from .random import seed

__all__ = ["convert_dtype", "seed"]
