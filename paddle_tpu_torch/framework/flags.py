"""Global flag registry (counterpart of ``paddle_tpu/framework/flags.py``).

A typed in-process registry: ``FLAGS_*`` environment variables override
the defaults at import, ``set_flags``/``get_flags`` read and write them
(paddle's API). The behavioural flag is ``FLAGS_check_nan_inf``: it
routes to the training-health plane (``profiler/health.py``), which arms
the eager per-op check and folds the sentinel into every TrainStep built
afterwards, as in the reference (l.89, 157, 217). The reference's flags
that steer JAX or XLA (``FLAGS_debug_nans``, the compilation and autotune
caches) have nothing to steer here and are not defined.
"""
from __future__ import annotations

import os
import sys
from typing import Any, Dict, List, Union


class _Flag:
    __slots__ = ("name", "value", "default", "type", "help")

    def __init__(self, name, default, help=""):
        self.name = name
        self.default = default
        self.value = default
        self.type = type(default)
        self.help = help


_REGISTRY: Dict[str, _Flag] = {}


def define_flag(name: str, default, help: str = ""):
    if not name.startswith("FLAGS_"):
        name = "FLAGS_" + name
    flag = _Flag(name, default, help)
    env = os.environ.get(name)
    if env is not None:
        flag.value = _parse(env, flag.type)
    _REGISTRY[name] = flag
    return flag


def _parse(s: str, ty):
    if ty is bool:
        return s.lower() in ("1", "true", "yes", "on")
    return ty(s)


def _full(name: str) -> str:
    return name if name.startswith("FLAGS_") else "FLAGS_" + name


def get_flags(flags: Union[str, List[str]]) -> Dict[str, Any]:
    """paddle.get_flags parity."""
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for name in map(_full, flags):
        if name not in _REGISTRY:
            raise ValueError(f"unknown flag {name}")
        out[name] = _REGISTRY[name].value
    return out


def set_flags(flags: Dict[str, Any]):
    """paddle.set_flags parity."""
    for name, value in flags.items():
        name = _full(name)
        if name not in _REGISTRY:
            raise ValueError(f"unknown flag {name}")
        flag = _REGISTRY[name]
        flag.value = _parse(value, flag.type) if isinstance(value, str) else \
            flag.type(value)
        _on_flag_set(name, flag.value)


def flag(name: str):
    """Fast internal read."""
    return _REGISTRY[_full(name)].value


def all_flags() -> Dict[str, Any]:
    return {n: f.value for n, f in _REGISTRY.items()}


def _on_flag_set(name: str, value):
    if name == "FLAGS_check_nan_inf":
        # arm (or disarm) the eager per-op check and its layer-path stack;
        # the health module reads the flag itself when it loads later
        h = sys.modules.get("paddle_tpu_torch.profiler.health")
        if h is not None:
            h.set_eager_check(bool(value))


define_flag("FLAGS_check_nan_inf", False,
            "training-health numerics plane (reference nan_inf_utils): "
            "the eager per-op check attributes the first NaN/Inf output to "
            "op + layer path (tensor_health event) and raises; TrainSteps "
            "built afterwards fold the health sentinel "
            "(profiler/health.py). See also PADDLE_TPU_HEALTH=1 "
            "(sentinel only)")
