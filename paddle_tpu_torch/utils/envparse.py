"""Shared parse helper for ``PADDLE_TPU_*`` environment knobs (a copy of
``paddle_tpu/utils/envparse.py``: the port imports nothing of the JAX
package, so it keeps its own).

Every numeric knob read in the package goes through this module (the
convention lint in ``paddle_tpu/analysis/conventions.py`` enforces it):
a garbled value — ``PADDLE_TPU_HEALTH_INTERVAL=ten`` — must NEVER
detonate as an anonymous ``int()``/``float()`` ValueError from deep
inside a training step. The PR-5/7 precedent applies everywhere now:

* the default mode **warns once** (naming the knob, the raw value, and
  the default being used) and degrades to the documented default — an
  operator typo does not take down a production job;
* ``strict=True`` raises :class:`EnvKnobError` (a ``ValueError`` that
  names the knob) for the few correctness-critical contracts where a
  silent default would diverge the fleet (the ``coordinator_from_env``
  MASTER_PORT pattern).

``env_bool`` canonicalizes the repo-wide truthiness convention: unset ->
``default``; ``0/false/off/no`` (case-insensitive) -> False; anything
else -> True. Knob names and defaults are documented in the README knob
tables — the convention lint checks every knob referenced in the package
appears there.
"""
from __future__ import annotations

import os
import threading
import warnings
from typing import Optional

__all__ = ["EnvKnobError", "env_int", "env_float", "env_bool", "env_str",
           "FALSEY"]

#: the repo-wide "off" spellings (case-insensitive)
FALSEY = ("0", "false", "off", "no")


class EnvKnobError(ValueError):
    """A PADDLE_TPU_* env knob held an unparseable value (strict mode)."""

    def __init__(self, name: str, raw: str, want: str):
        super().__init__(
            f"{name}={raw!r} is not a valid {want}; unset it or set a "
            f"{want} value")
        self.name = name
        self.raw = raw


# warn once per (knob, raw value): several knobs are re-read per
# construction (EventLog, watchdog) and a garbled value must not spam
_warned: set = set()
_warned_lock = threading.Lock()


def _warn_once(name: str, raw: str, want: str, default):
    key = (name, raw)
    with _warned_lock:
        if key in _warned:
            return
        _warned.add(key)
    warnings.warn(f"{name}={raw!r} is not a valid {want}; "
                  f"using the default ({default})")


def _reset_warned():
    """Test hook: let regression tests assert the warning re-fires."""
    with _warned_lock:
        _warned.clear()


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """Raw string read (empty string counts as unset)."""
    raw = os.environ.get(name, "")
    return raw if raw else default


def env_int(name: str, default: int, *, strict: bool = False) -> int:
    """Integer knob: unset/empty -> default; garbled -> warn + default,
    or EnvKnobError naming the knob under ``strict=True``."""
    raw = os.environ.get(name, "")
    if not raw.strip():
        return default
    try:
        return int(raw)
    except ValueError:
        if strict:
            raise EnvKnobError(name, raw, "integer") from None
        _warn_once(name, raw, "integer", default)
        return default


def env_float(name: str, default: float, *, strict: bool = False) -> float:
    """Float knob: unset/empty -> default; garbled -> warn + default,
    or EnvKnobError naming the knob under ``strict=True``."""
    raw = os.environ.get(name, "")
    if not raw.strip():
        return default
    try:
        return float(raw)
    except ValueError:
        if strict:
            raise EnvKnobError(name, raw, "number") from None
        _warn_once(name, raw, "number", default)
        return default


def env_bool(name: str, default: bool = True) -> bool:
    """Truthiness knob: unset -> default; 0/false/off/no -> False;
    anything else -> True (the repo-wide kill-switch convention)."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    return raw.strip().lower() not in FALSEY
