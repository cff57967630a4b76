"""The subset of ``paddle_tpu.framework`` the port has: dtypes, seeding and
the RNG state, the flag registry, and ``save``/``load``."""
from .dtype import convert_dtype
from .flags import get_flags, set_flags
from .io import load, save
from .random import get_rng_state, seed, set_rng_state

__all__ = ["convert_dtype", "get_flags", "get_rng_state", "load", "save",
           "seed", "set_flags", "set_rng_state"]
