"""Automatic mixed precision by op name (counterpart of the AMP part of
``paddle_tpu/ops/_dispatch.py``, l.528-559).

The reference casts each op's inputs in its dispatch, by the op's name:
``AMP_WHITE`` (products, convolutions) to the amp type, ``AMP_BLACK``
(losses, norms, reductions, exp and log) to float32, every other op
following its inputs. The port has no per-op dispatch, so the
``nn.functional`` entry points that the lists name call
:func:`maybe_autocast` on their inputs (``linear``, ``conv2d``;
``layer_norm``, ``cross_entropy``, ``log_softmax``); the rest follow
their inputs as in the reference. ``torch.autocast`` is not used: its
lists differ from these, and it cannot cast the inputs of the kernels,
which launch through ctypes. ``amp.auto_cast`` sets the state.
"""
from __future__ import annotations

import torch

#: ops run in the amp type (MXU- or tensor-core-bound)
AMP_WHITE = {"matmul", "conv2d", "conv1d", "conv3d", "conv2d_transpose",
             "linear", "bmm", "mm", "einsum", "addmm"}
#: ops run in float32
AMP_BLACK = {"softmax_with_cross_entropy", "cross_entropy", "log_softmax",
             "mean", "sum", "norm", "exp", "log", "logsumexp", "var", "std",
             "layer_norm", "batch_norm"}

_amp_state = {"enabled": False, "dtype": torch.bfloat16, "level": "O1",
              "custom_white": set(), "custom_black": set()}

_HALF = (torch.float16, torch.bfloat16)


def amp_state() -> dict:
    """The process's autocast state, which ``amp.auto_cast`` sets."""
    return _amp_state


def maybe_autocast(name: str, *tensors):
    """``tensors`` as op ``name`` takes them under the current autocast
    state: a white-listed op's floating inputs in the amp type, a
    black-listed op's half-precision inputs in float32, anything else
    (and ``None``) unchanged. The custom lists move an op between the
    lists, as in the reference."""
    st = _amp_state
    if not st["enabled"]:
        return tensors
    white = (AMP_WHITE | st["custom_white"]) - st["custom_black"]
    black = (AMP_BLACK | st["custom_black"]) - st["custom_white"]
    if name in white:
        amp = st["dtype"]
        return tuple(t.to(amp) if t is not None and t.is_floating_point()
                     and t.dtype != amp else t for t in tensors)
    if name in black:
        return tuple(t.float() if t is not None and t.dtype in _HALF else t
                     for t in tensors)
    return tensors
