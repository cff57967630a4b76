"""Checkpoint save/load (counterpart of ``paddle_tpu/framework/io.py``).

``save``/``load`` write pickled nested state dicts of numpy arrays, the
reference's format, so a file written by either package loads in the
other: a tensor leaf is the reference's ``{"__tensor__": True, "data":
ndarray, ...}`` record. ``load`` gives torch tensors on the CPU (or numpy
with ``return_numpy=True``).

Two types numpy lacks need a rule, and this module holds both for the
whole port (``distributed/checkpoint.py`` writes through it too):

* **bfloat16.** The reference's bf16 arrays are ``ml_dtypes`` arrays,
  which pickle as an ``ndarray`` whose dtype is ``ml_dtypes.bfloat16``.
  The port writes a bf16 tensor in exactly that form (the raw 16-bit
  words, the same opcodes), so the JAX package reads it as its own bf16
  array; and it reads that form back into a ``torch.bfloat16`` tensor
  without importing ``ml_dtypes`` (which the card's machine does not
  have): :class:`_Unpickler` resolves the ``ml_dtypes.bfloat16`` global
  to a marker and rebuilds such arrays itself.
* **JAX objects.** A pickle that names a ``jax``, ``jaxlib`` or
  ``paddle_tpu`` global is refused: loading never imports the JAX
  package (the reference converts every array to numpy before writing).

``cipher_key=`` (the reference's AES-CTR model encryption) needs the
reference's C++ cipher (``_native/csrc/crypto.cc``), which is ROADMAP
A12: until then it raises ``NotImplementedError``.
"""
from __future__ import annotations

import io
import os
import pickle
import tempfile

import numpy as np
import torch

# process umask, captured once while single-threaded: mkstemp creates 0600
# files, but a published checkpoint must keep the umask-default mode a
# plain open() gives (group-readable checkpoints feed eval jobs)
_UMASK = os.umask(0)
os.umask(_UMASK)

_ENC_MAGIC = b"PDTPUAES1\x00"
_FORBIDDEN_ROOTS = ("jax", "jaxlib", "paddle_tpu")

# numpy's own array and scalar constructors, as its pickles name them
_NP_RECONSTRUCT = np.ndarray.__reduce__(np.zeros(1))[0]
_NP_SCALAR = np.float32(0).__reduce__()[0]
# the state numpy's ml_dtypes-bfloat16 dtype pickles with (a little-endian
# 2-byte user type), written after np.dtype(ml_dtypes.bfloat16, 0, 1)
_BF16_DTYPE_STATE = (3, "<", None, None, None, 2, 2, 64)


def _atomic_write(path: str, *parts) -> None:
    """The one atomic-publish protocol for checkpoint-like files (also used
    by distributed/checkpoint.py): the buffers ``parts`` written in turn
    to a unique tmp in the target dir, umask-default mode, ``os.replace``
    — a crash mid-write never leaves a torn file at the published path,
    concurrent writers never share a tmp."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            for part in parts:
                f.write(part)
        os.chmod(tmp, 0o666 & ~_UMASK)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


# ---------------------------------------------------------------------------
# the pickle rules (shared with distributed/checkpoint.py)
# ---------------------------------------------------------------------------
class bfloat16:
    """Stands for ``ml_dtypes.bfloat16`` in a pickle: written as that
    global, and what reading that global gives."""


class _BF16Dtype:
    """A bfloat16 numpy dtype, as pickled (``np.dtype(ml_dtypes.bfloat16,
    False, True)`` and its state); reading one gives this object back."""

    def __reduce__(self):
        return (np.dtype, (bfloat16, False, True), _BF16_DTYPE_STATE)

    def __setstate__(self, state):
        pass


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, able to write the ``ml_dtypes.bfloat16``
    global without importing ``ml_dtypes``; a bf16 tensor is written as the
    reference's bf16 ndarray."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            if obj.dtype != torch.bfloat16:
                raise pickle.PicklingError(
                    "only bfloat16 tensors reach the pickler; convert the "
                    "others to numpy first")
            raw = obj.detach().cpu().contiguous().view(torch.int16) \
                .numpy().tobytes()
            return (_NP_RECONSTRUCT, (np.ndarray, (0,), b"b"),
                    (1, tuple(obj.shape), _BF16Dtype(), False, raw))
        return NotImplemented

    def save_global(self, obj, name=None):
        if obj is bfloat16:
            self.save("ml_dtypes")
            self.save("bfloat16")
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


def _dumps(obj) -> memoryview:
    """Pickle ``obj`` (numpy arrays, bf16 tensors, builtins) at protocol 4."""
    buf = io.BytesIO()
    _Pickler(buf, protocol=4).dump(obj)
    return buf.getbuffer()


class _ArrayStub:
    """An array while it is being unpickled; :func:`_resolve` swaps in the
    array (or the bf16 tensor) once its state is known."""

    __slots__ = ("args", "value")

    def __init__(self, *args):
        self.args = args
        self.value = None

    def __setstate__(self, state):
        _, shape, dtype, _fortran, raw = state
        if isinstance(dtype, _BF16Dtype):
            words = np.frombuffer(raw, dtype=np.int16).reshape(shape)
            self.value = torch.from_numpy(words.copy()).view(torch.bfloat16)
        else:
            arr = _NP_RECONSTRUCT(*self.args)
            arr.__setstate__(state)
            self.value = arr


def _np_dtype(obj, align=False, copy=False):
    if obj is bfloat16:
        return _BF16Dtype()
    return np.dtype(obj, align, copy)


def _np_scalar(dtype, data=None):
    if isinstance(dtype, _BF16Dtype):
        word = np.frombuffer(data, dtype=np.int16).copy()
        return float(torch.from_numpy(word).view(torch.bfloat16)[0])
    return _NP_SCALAR(dtype, data) if data is not None else _NP_SCALAR(dtype)


class _Unpickler(pickle.Unpickler):
    """Reads the reference's pickles without JAX or ``ml_dtypes``."""

    def find_class(self, module, name):
        if module.split(".")[0] in _FORBIDDEN_ROOTS:
            raise pickle.UnpicklingError(
                f"refusing to import {module}.{name}: a checkpoint holds "
                f"numpy arrays and builtins only")
        if module == "ml_dtypes" and name == "bfloat16":
            return bfloat16
        if module == "numpy" and name == "dtype":
            return _np_dtype
        if module.startswith("numpy") and name == "_reconstruct":
            return _ArrayStub
        if module.startswith("numpy") and name == "scalar":
            return _np_scalar
        return super().find_class(module, name)


def _resolve(obj):
    if isinstance(obj, _ArrayStub):
        return obj.value
    if isinstance(obj, dict):
        return {k: _resolve(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_resolve(v) for v in obj]
    if isinstance(obj, tuple):
        return type(obj)(*map(_resolve, obj)) if hasattr(obj, "_fields") \
            else tuple(_resolve(v) for v in obj)
    return obj


def _loads(data) -> object:
    """Unpickle ``data`` by the rules above: numpy arrays stay numpy, bf16
    arrays come back as ``torch.bfloat16`` tensors."""
    return _resolve(_Unpickler(io.BytesIO(data)).load())


#: numpy dtypes torch holds natively (the others stay numpy on load)
_TORCH_KINDS = {np.dtype(t) for t in (
    np.float16, np.float32, np.float64, np.complex64, np.complex128,
    np.int8, np.int16, np.int32, np.int64, np.uint8, np.bool_)}


def to_torch(obj):
    """Every numpy array of ``obj`` (a nested dict/list/tuple) that torch
    can hold, as a CPU tensor sharing its memory."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj) if obj.dtype in _TORCH_KINDS else obj
    if isinstance(obj, dict):
        return {k: to_torch(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_torch(v) for v in obj)
    return obj


def to_host(t: torch.Tensor):
    """A snapshot of ``t`` on the host that the caller owns: numpy, or a
    CPU bf16 tensor (numpy has no bf16)."""
    t = t.detach().to("cpu", copy=True)
    return t if t.dtype == torch.bfloat16 else t.numpy()


# ---------------------------------------------------------------------------
# paddle.save / paddle.load
# ---------------------------------------------------------------------------
def _to_saveable(obj):
    if isinstance(obj, torch.Tensor):
        return {"__tensor__": True, "data": to_host(obj),
                "stop_gradient": not obj.requires_grad,
                "is_param": isinstance(obj, torch.nn.Parameter),
                "name": getattr(obj, "param_name", None)}
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def _tensor_of(data) -> torch.Tensor:
    return data if isinstance(data, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(data))


def _from_saveable(obj, return_numpy=False):
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            if return_numpy:
                return obj["data"]
            t = _tensor_of(obj["data"])
            if obj.get("is_param"):
                t = torch.nn.Parameter(t)
            elif not obj.get("stop_gradient", True):
                t.requires_grad_(True)
            return t
        return {k: _from_saveable(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saveable(v, return_numpy) for v in obj)
    return obj


def _no_cipher(cipher_key):
    if cipher_key is not None:
        raise NotImplementedError(
            "cipher_key=: the AES-CTR model cipher needs the reference's "
            "C++ crypto library, which is not ported yet (ROADMAP A12)")


def save(obj, path, protocol=4, cipher_key: bytes = None, **configs):
    """paddle.save: pickle ``obj`` (tensors as the reference's records)
    atomically to ``path``."""
    _no_cipher(cipher_key)
    if protocol != 4:
        raise ValueError("the port writes pickle protocol 4 (the reference's "
                         "default)")
    _atomic_write(path, _dumps(_to_saveable(obj)))


def _is_reference_format(raw) -> bool:
    return isinstance(raw, dict) and (
        "StructuredToParameterName@@" in raw
        or "UnpackBigParamInfor@@" in raw)


def _decode_reference(obj, return_numpy):
    """Decode a checkpoint written by Paddle's own ``paddle.save``
    (state_dict values are plain ndarrays, big params are split into
    ``key@@.N`` slices with an ``UnpackBigParamInfor@@`` manifest, and
    Tensors nested in other containers pickle to a ``((name, ndarray),)``
    tuple), as the reference's loader does."""
    if isinstance(obj, dict):
        obj = dict(obj)
        info = obj.pop("UnpackBigParamInfor@@", None)
        if info:
            for key, val in info.items():
                slices = [obj.pop(p) for p in val["slices"]]
                obj[key] = np.concatenate(
                    [np.asarray(s) for s in slices]).reshape(
                        val["OriginShape"])
        obj.pop("StructuredToParameterName@@", None)
        return {k: _decode_reference(v, return_numpy) for k, v in obj.items()}
    if (isinstance(obj, tuple) and len(obj) == 1
            and isinstance(obj[0], tuple) and len(obj[0]) == 2
            and isinstance(obj[0][0], str)
            and isinstance(obj[0][1], np.ndarray)):
        arr = obj[0][1]
        return arr if return_numpy else _tensor_of(arr)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_decode_reference(v, return_numpy) for v in obj)
    if isinstance(obj, np.ndarray):
        return obj if return_numpy else _tensor_of(obj)
    return obj


def match_state_dict(layer, state_dict):
    """Name-map a (possibly prefixed) state_dict onto `layer`: find the
    key prefix (``bert.``, ...) with the best overlap with the layer's own
    keys, strip it, and return (matched, missing, unexpected) — apply with
    ``layer.load_state_dict(matched, strict=False)``."""
    want = set(layer.state_dict().keys())
    keys = list(state_dict.keys())
    prefixes = {""}
    for k in keys:
        parts = k.split(".")
        for i in (1, 2):
            if len(parts) > i:
                prefixes.add(".".join(parts[:i]) + ".")

    def overlap(pref):
        return sum(1 for k in keys
                   if k.startswith(pref) and k[len(pref):] in want)
    best = max(sorted(prefixes), key=overlap)
    matched = {k[len(best):]: v for k, v in state_dict.items()
               if k.startswith(best) and k[len(best):] in want}
    missing = sorted(want - set(matched))
    unexpected = sorted(k for k in keys
                        if not (k.startswith(best)
                                and k[len(best):] in want))
    return matched, missing, unexpected


def load(path, return_numpy=False, cipher_key: bytes = None, **configs):
    """paddle.load: tensors come back as CPU torch tensors (numpy with
    ``return_numpy=True``; a bf16 leaf is a bf16 tensor either way)."""
    _no_cipher(cipher_key)
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_ENC_MAGIC):
        raise NotImplementedError(
            f"{path} is AES-encrypted: the model cipher is not ported yet "
            f"(ROADMAP A12)")
    raw = _loads(data)
    if _is_reference_format(raw):
        return _decode_reference(raw, return_numpy)
    return _from_saveable(raw, return_numpy=return_numpy)


__all__ = ["save", "load", "match_state_dict"]
