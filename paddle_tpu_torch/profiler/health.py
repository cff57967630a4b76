"""Training-health numerics plane (counterpart of
``paddle_tpu/profiler/health.py``): the step sentinel, first-NaN
attribution, and divergence detection with its auto-response.

Three tiers, as in the reference:

1.  **Step sentinel** — :class:`HealthProbe` reduces one step's loss,
    gradients and parameters to one small float32 vector on the device:
    the loss, an any-nonfinite flag, the global gradient, update and
    parameter norms, per-layer-group gradient norms and per-group
    nonfinite-parameter flags. The reference folds it into its compiled
    XLA step; here it is a fixed handful of multi-tensor reductions
    (``torch._foreach_norm`` over every tensor at once, then one
    ``index_add_`` per group quantity), so the number of launches does
    not grow with depth. The host fetches the vector once every
    ``PADDLE_TPU_HEALTH_INTERVAL`` steps.

2.  **Eager first-NaN attribution** — under ``FLAGS_check_nan_inf`` every
    op output is checked (a ``TorchDispatchMode`` over the aten ops; the
    kernel wrappers of ``ops/kernels`` check their own outputs under
    their own names, with the mode suspended inside them), and the first
    bad output emits a ``tensor_health`` event naming the op, the layer
    path (global module hooks, registered only while armed), the shape,
    type and bad-value kind, then raises ``FloatingPointError``. A
    tripped sentinel replays the last batch's forward and loss once with
    the check armed (:func:`eager_replay`).

3.  **Trend detection + auto-response** — :class:`HealthMonitor` (a hapi
    callback): loss spikes (EWMA z-score), gradient explosion and
    vanishing, stagnation; on confirmed divergence ``warn``, ``halt`` or
    ``rollback`` (restore the last numerically valid checkpoint through
    ``distributed/checkpoint.py``). The reference's ``fleet`` response
    waits for the fleet plane (ROADMAP A11/A12) and raises.

Opt-in: ``PADDLE_TPU_HEALTH=1`` or ``FLAGS_check_nan_inf`` folds the
sentinel into every TrainStep built afterwards; the per-op check follows
``FLAGS_check_nan_inf`` alone and raises on the first bad op (reference
semantics).
"""
from __future__ import annotations

import contextlib
import math
import os
import threading
import time
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..framework import flags as _flags_mod
from . import events as _events_mod
from . import metrics as _metrics_mod

__all__ = [
    "HealthProbe", "HealthMonitor", "enabled", "interval", "record_step_stats",
    "last_stats", "last_status", "snapshot", "eager_replay", "note_bad_tensor",
    "index_model", "reset", "HEALTH_EVENT_KINDS",
]

#: event kinds this plane emits (subset of events.KINDS)
HEALTH_EVENT_KINDS = ("tensor_health", "health_alert", "health_rollback")

_REG = _metrics_mod.default_registry()
_M_LOSS = _REG.gauge(
    "health_loss",
    "newest loss value the health sentinel fetched (finite values only)")
_M_GRAD_NORM = _REG.gauge(
    "health_grad_norm",
    "newest global gradient L2 norm from the step sentinel (finite "
    "values only)")
_M_UPDATE_RATIO = _REG.gauge(
    "health_update_ratio",
    "newest parameter update/param L2-norm ratio from the sentinel "
    "(finite values only)")
_M_LAYER_GRAD = _REG.gauge(
    "health_layer_grad_norm",
    "per-layer-group gradient L2 norm from the sentinel, by group "
    "(bucketed parameter-tree path, bounded cardinality)")
_M_NONFINITE = _REG.counter(
    "health_nonfinite_total",
    "nonfinite detections by src (sentinel: the step probe tripped; "
    "eager: the per-op post-check fired)")
_M_ALERTS = _REG.counter(
    "health_alerts_total",
    "HealthMonitor alerts by signal (nonfinite, loss_spike, "
    "grad_explosion, grad_vanishing, stagnation)")
_M_ROLLBACK = _REG.counter(
    "health_rollback_total",
    "divergence auto-responses that restored the last valid checkpoint")


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------
def enabled() -> bool:
    """True when the sentinel should be folded into TrainSteps:
    PADDLE_TPU_HEALTH=1, or FLAGS_check_nan_inf (which also arms the
    eager per-op check)."""
    if os.environ.get("PADDLE_TPU_HEALTH", "").lower() in (
            "1", "true", "yes", "on"):
        return True
    return bool(_flags_mod.flag("FLAGS_check_nan_inf"))


def interval() -> int:
    """Sentinel cadence in steps: the vector is formed and fetched once
    every ``interval()`` steps (this bounds the device->host transfers
    and the detection latency)."""
    from ..utils.envparse import env_int
    return max(1, env_int("PADDLE_TPU_HEALTH_INTERVAL", 1))


def action() -> str:
    """The configured divergence response: warn | halt | rollback | fleet."""
    a = os.environ.get("PADDLE_TPU_HEALTH_ACTION", "warn").lower()
    return a if a in ("warn", "halt", "rollback", "fleet") else "warn"


def max_groups() -> int:
    from ..utils.envparse import env_int
    return max(1, env_int("PADDLE_TPU_HEALTH_GROUPS", 32))


# ---------------------------------------------------------------------------
# tier 1: step sentinel
# ---------------------------------------------------------------------------
def _group_name(param_name: str) -> str:
    """Bucket a dotted parameter path into a layer group: drop the leaf
    (weight/bias/...), keep the first two components of what remains —
    'blocks.3.attn.qkv.weight' -> 'blocks.3', 'fc2.bias' -> 'fc2'."""
    parts = param_name.split(".")[:-1]
    return ".".join(parts[:2]) if parts else "(root)"


class HealthProbe:
    """Forms the packed on-device stats vector for one parameter dict.

    The group layout is fixed at construction from the parameter names,
    exactly as in the reference (sorted group names, or ``bucketNN``
    crc32 buckets past ``max_groups``).

    Layout: ``[loss, nonfinite_flag, grad_norm, param_norm, update_norm,
    group_0_grad_norm, ..., group_{G-1}_grad_norm, group_0_param_bad,
    ..., group_{G-1}_param_bad]``, float32. The reference packs squared
    norms; this vector packs the norms, reduced with float64 sums, so a
    finite tensor never yields an infinite entry: the flags follow
    ``isfinite`` of the tensors alone, and a norm that would overflow a
    float32 square does not trip the sentinel.

    The per-group PARAMETER flags name the layer that went bad first:
    once the loss is NaN, backprop poisons every gradient in the same
    step, but the incoming parameters are bad only in the group that
    went bad.
    """

    N_FIXED = 5

    def __init__(self, params: Dict[str, object],
                 max_groups_: Optional[int] = None):
        cap = max_groups_ if max_groups_ is not None else max_groups()
        raw: Dict[str, List[str]] = {}
        for name in params:
            raw.setdefault(_group_name(name), []).append(name)
        names = sorted(raw)
        self._group_of: Dict[str, int] = {}
        if len(names) > cap:
            # bounded cardinality: hash-bucket the tree paths so the
            # vector (and the gauge label set) never grows with model depth
            self.group_names = [f"bucket{i:02d}" for i in range(cap)]
            for gname, members in raw.items():
                idx = zlib.crc32(gname.encode()) % cap
                for m in members:
                    self._group_of[m] = idx
        else:
            self.group_names = names
            for i, gname in enumerate(names):
                for m in raw[gname]:
                    self._group_of[m] = i
        self._names = list(params)
        self._index: Dict[torch.device, torch.Tensor] = {}

    def _group_index(self, names, device) -> torch.Tensor:
        key = (tuple(names), device)
        idx = self._index.get(key)
        if idx is None:
            idx = self._index[key] = torch.tensor(
                [self._group_of[n] for n in names], dtype=torch.long,
                device=device)
        return idx

    @torch.no_grad()
    def stats_vec(self, loss, grads, params, new_params) -> torch.Tensor:
        """The packed float32 stats vector (see the class docstring), on
        the loss's device. ``params`` are the step's incoming parameters
        and ``new_params`` the updated ones ({name: tensor} each); the
        number of ops is the same for any number of parameters."""
        f64 = torch.float64
        names = [n for n in self._names if n in grads
                 and grads[n].is_floating_point()]
        N = len(names)
        dev = grads[names[0]].device
        idx = self._group_index(names, dev)
        old = [params[n] for n in names]
        delta = torch._foreach_sub([new_params[n] for n in names], old)
        # one multi-tensor norm over gradients, parameters and updates;
        # float64 sums keep a finite tensor's norm finite
        norms = torch.stack(torch._foreach_norm(
            [grads[n] for n in names] + old + list(delta), 2,
            dtype=f64)).view(3, N)
        del delta
        sq = norms * norms
        bad = (norms[:2] * 0).isnan()     # [grad, param] not finite
        per = torch.stack([sq[0], bad[1].to(f64)], 1)
        group = torch.zeros(len(self.group_names), 2, dtype=f64,
                            device=dev).index_add_(0, idx, per)
        loss64 = loss.detach().reshape(1).to(f64)
        flag = torch.cat([bad.view(-1), (loss64 * 0).isnan()]).any()
        return torch.cat([loss64, flag.to(f64).view(1), sq.sum(1).sqrt(),
                          group[:, 0].sqrt(),
                          (group[:, 1] > 0).to(f64)]).to(torch.float32)

    def decode(self, vec) -> dict:
        """Host side: one fetched vector -> a stats dict."""
        v = np.asarray(vec, dtype=np.float64)
        n_groups = len(self.group_names)
        nonfinite = bool(v[1] > 0) or not math.isfinite(v[0])
        grad_norm, par, upd = float(v[2]), float(v[3]), float(v[4])
        groups = {name: float(v[self.N_FIXED + i])
                  for i, name in enumerate(self.group_names)}
        bad_params = [name for i, name in enumerate(self.group_names)
                      if v[self.N_FIXED + n_groups + i] > 0]
        with np.errstate(invalid="ignore"):
            ratio = (upd / par) if par > 0 else upd
        return {
            "loss": float(v[0]),
            "nonfinite": nonfinite,
            "grad_norm": grad_norm,
            "param_norm": par,
            "update_ratio": ratio,
            "group_grad_norms": groups,
            # groups whose incoming (pre-update) params held NaN/Inf —
            # the first-bad-layer attribution (see class docstring)
            "bad_param_groups": bad_params,
        }


# ---------------------------------------------------------------------------
# module state: last sentinel stats / status / alerts (the snapshot surface)
# ---------------------------------------------------------------------------
_state_lock = threading.Lock()
_last_stats: Optional[dict] = None
_status: Optional[str] = None          # ok | warn | diverged
_alerts: "deque[dict]" = deque(maxlen=32)
_rollback_count = 0
_trip_active = False                   # sentinel currently tripped
_last_attribution: Optional[dict] = None


def _f(x) -> Optional[float]:
    """Finite float or None — keeps NaN/Inf out of gauges and JSON."""
    try:
        x = float(x)
    except (TypeError, ValueError):
        return None
    return x if math.isfinite(x) else None


def record_step_stats(stats: dict, step: int,
                      source: str = "sentinel") -> dict:
    """Fold one decoded sentinel fetch into the health plane: gauges,
    last-stats snapshot, status, and (on a nonfinite flag) the
    ``tensor_health`` trip event. Returns the stored record. Never
    raises — health telemetry must not take down training."""
    global _last_stats, _status, _trip_active
    rec = dict(stats)
    rec["step"] = int(step)
    rec["ts"] = time.time()
    nonfinite = bool(rec.get("nonfinite"))
    try:
        if _metrics_mod.enabled():
            for gauge, key in ((_M_LOSS, "loss"),
                               (_M_GRAD_NORM, "grad_norm"),
                               (_M_UPDATE_RATIO, "update_ratio")):
                val = _f(rec.get(key))
                if val is not None:
                    gauge.set(val)
            for gname, gv in (rec.get("group_grad_norms") or {}).items():
                val = _f(gv)
                if val is not None:
                    _M_LAYER_GRAD.set(val, group=gname)
    except Exception:
        pass
    with _state_lock:
        _last_stats = rec
        tripped_now = nonfinite and not _trip_active
        _trip_active = nonfinite
        _status = "diverged" if nonfinite else (
            "ok" if _status != "warn" else _status)
    if tripped_now:
        # name the origin: groups whose pre-update PARAMS were bad, else
        # the groups whose grad norms came back nonfinite
        bad_groups = list(rec.get("bad_param_groups") or [])
        if not bad_groups:
            bad_groups = sorted(
                g for g, v in (rec.get("group_grad_norms") or {}).items()
                if _f(v) is None)
        try:
            if _metrics_mod.enabled():
                _M_NONFINITE.inc(src=source)
            _events_mod.emit(
                "tensor_health", severity="error", src=source,
                step=int(step), loss=_f(rec.get("loss")),
                grad_norm=_f(rec.get("grad_norm")),
                bad_groups=bad_groups)
        except Exception:
            pass
    return rec


def last_stats() -> Optional[dict]:
    with _state_lock:
        return dict(_last_stats) if _last_stats else None


def last_status() -> Optional[str]:
    with _state_lock:
        return _status


def set_status(status: str):
    global _status
    with _state_lock:
        _status = status


def tripped() -> bool:
    """True while the newest sentinel fetch held NaN/Inf. The
    FaultTolerantCheckpoint consults this to SKIP saves of known-bad
    state."""
    with _state_lock:
        return _trip_active


def clear_trip():
    """Re-arm the sentinel trip (after a rollback restored good state)."""
    global _trip_active
    with _state_lock:
        _trip_active = False


def note_alert(rec: dict):
    with _state_lock:
        _alerts.append(rec)


def note_rollback():
    global _rollback_count
    with _state_lock:
        _rollback_count += 1


def _json_safe(obj):
    """Recursively replace nonfinite floats with None."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


def snapshot() -> dict:
    """The ``health`` section of an observability snapshot."""
    with _state_lock:
        return {
            "enabled": enabled(),
            "eager_check": bool(_ATTRIBUTION_ARMED),
            "interval": interval(),
            "action": action(),
            "status": _status,
            "tripped": _trip_active,
            "last": _json_safe(dict(_last_stats)) if _last_stats else None,
            "last_attribution": (dict(_last_attribution)
                                 if _last_attribution else None),
            "alerts_tail": [_json_safe(dict(a))
                            for a in list(_alerts)[-10:]],
            "rollbacks": _rollback_count,
        }


def reset():
    """Test hook: clear all module state (metrics families stay)."""
    global _last_stats, _status, _rollback_count, _trip_active
    global _last_attribution
    with _state_lock:
        _last_stats = None
        _status = None
        _rollback_count = 0
        _trip_active = False
        _last_attribution = None
        _alerts.clear()


# ---------------------------------------------------------------------------
# tier 2: eager first-NaN attribution (layer stack + per-op check + replay)
# ---------------------------------------------------------------------------
# Armed while FLAGS_check_nan_inf is on, or for the duration of an
# eager_replay; the kernel wrappers read it once per call.
_ATTRIBUTION_ARMED = False
_tls = threading.local()

# id(module) -> dotted path, for every model registered via index_model
_layer_index: Dict[int, str] = {}

_NAN_FLAG = _flags_mod._REGISTRY["FLAGS_check_nan_inf"]

# aten ops whose outputs are uninitialised memory: never checked
_UNINITIALISED = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided", "resize_", "empty_permuted"}


def _suspended() -> bool:
    return getattr(_tls, "suspend", 0) > 0


@contextlib.contextmanager
def suspended():
    """No per-op check inside the block (a kernel wrapper's plain
    version, a TrainStep's own forward and backward: the reference checks
    eager ops only, never the ops inside its compiled step)."""
    _tls.suspend = getattr(_tls, "suspend", 0) + 1
    try:
        yield
    finally:
        _tls.suspend -= 1


def op_check_on() -> bool:
    """The per-op check fires: FLAGS_check_nan_inf is on and no
    :func:`suspended` block is open on this thread."""
    return bool(_NAN_FLAG.value) and not _suspended()


def _check_outputs(op: str, outs) -> None:
    """Raise FloatingPointError (after :func:`note_bad_tensor`) on the
    first output of `op` holding NaN or Inf."""
    if isinstance(outs, torch.Tensor):
        outs = (outs,)
    elif not isinstance(outs, (list, tuple)):
        return
    for i, o in enumerate(outs):
        if not isinstance(o, torch.Tensor) or o.numel() == 0 or not (
                o.is_floating_point() or o.is_complex()):
            continue
        with suspended():  # the check's own ops are not checked
            if bool(torch.isfinite(o).all()):
                continue
            # failure path only: one more small fetch to name the kind
            kind = "nan" if bool(torch.isnan(o).any()) else "inf"
        dtype = str(o.dtype).replace("torch.", "")
        rec = note_bad_tensor(op=op, output_index=i, shape=tuple(o.shape),
                              dtype=dtype, kind=kind)
        where = f" in layer '{rec['layer']}'" if rec.get("layer") else ""
        raise FloatingPointError(
            f"Operator '{op}' output {i} contains {kind}{where} "
            f"(shape {tuple(o.shape)}, dtype {dtype}). Enabled by "
            f"FLAGS_check_nan_inf.")


def run_checked(op: str, fn: Callable, *args, **kwargs):
    """Run a kernel wrapper's body ``fn``: unarmed, a plain call; armed,
    with the per-op check suspended inside it (the plain version's aten
    ops are not the reference's ops) and its output checked under the
    wrapper's name `op`, the name the reference's dispatch reports."""
    if not _ATTRIBUTION_ARMED:
        return fn(*args, **kwargs)
    with suspended():
        out = fn(*args, **kwargs)
    if op_check_on():
        _check_outputs(op, out)
    return out


class _NanCheckMode(TorchDispatchMode):
    """Checks every aten op's floating outputs (the counterpart of the
    reference's dispatch post-check, ``ops/_dispatch.py:482-519``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name not in _UNINITIALISED and op_check_on():
            _check_outputs(name, out)
        return out


_armed_state = {"mode": None, "hooks": ()}


def _push_layer(module, args):
    push_layer(module)


def _pop_layer(module, args, out):
    pop_layer()


def set_eager_check(on: bool):
    """Called by framework.flags when FLAGS_check_nan_inf changes (and by
    eager_replay): arms or disarms the per-op check mode and the global
    module hooks that keep the layer-path stack."""
    global _ATTRIBUTION_ARMED
    on = bool(on)
    if on == _ATTRIBUTION_ARMED:
        return
    _ATTRIBUTION_ARMED = on
    mm = torch.nn.modules.module
    if on:
        _tls.stack = []
        _armed_state["hooks"] = (
            mm.register_module_forward_pre_hook(_push_layer),
            mm.register_module_forward_hook(_pop_layer, always_call=True))
        mode = _NanCheckMode()
        mode.__enter__()
        _armed_state["mode"] = mode
    else:
        for h in _armed_state["hooks"]:
            h.remove()
        _armed_state["hooks"] = ()
        mode, _armed_state["mode"] = _armed_state["mode"], None
        if mode is not None:
            mode.__exit__(None, None, None)


def push_layer(layer):
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(layer)


def pop_layer():
    stack = getattr(_tls, "stack", None)
    if stack:
        stack.pop()


def index_model(root) -> Dict[int, str]:
    """Map every submodule of `root` to its dotted path so attribution can
    name real parameter-tree locations instead of class names."""
    idx = {id(root): "(root)"}
    for name, sub in root.named_modules():
        if name:
            idx[id(sub)] = name
    _layer_index.update(idx)
    return idx


def current_layer_path() -> Optional[str]:
    """Innermost indexed module on this thread's call stack; falls back to
    the class-name chain when no model was indexed."""
    stack = getattr(_tls, "stack", None)
    if not stack:
        return None
    for layer in reversed(stack):
        path = _layer_index.get(id(layer))
        if path is not None:
            return path
    return "/".join(type(l).__name__ for l in stack)


def note_bad_tensor(op: str, output_index: int, shape, dtype: str,
                    kind: str) -> dict:
    """Called by the per-op check on the FIRST bad op output: emit the
    `tensor_health` attribution event naming op + layer path +
    shape/dtype + bad-value kind. Returns the record."""
    global _last_attribution
    rec = {
        "src": "eager",
        "op": op,
        "layer": current_layer_path(),
        "output_index": int(output_index),
        "shape": list(shape),
        "dtype": str(dtype),
        "bad_kind": kind,
    }
    with _state_lock:
        _last_attribution = rec
    try:
        if _metrics_mod.enabled():
            _M_NONFINITE.inc(src="eager")
        _events_mod.emit("tensor_health", severity="error", **rec)
    except Exception:
        pass
    return rec


def eager_replay(layer, loss_fn: Callable, arrs,
                 state: Optional[dict] = None) -> Optional[dict]:
    """One-shot attribution: re-run a batch's forward + loss with the
    per-op NaN check armed. The check raises on (and attributes) the
    first bad op output; the exception is swallowed here — this is
    diagnosis, not control flow. ``arrs`` is the batch (inputs, then the
    label). With ``state`` ({name: tensor} parameters and buffers) the
    layer runs on those through ``functional_call`` (a TrainStep replays
    with the parameters its step took in). Returns the attribution
    record, or None if the pass stayed clean (e.g. only the optimizer
    update was bad)."""
    global _last_attribution
    prev_flag, prev_armed = _NAN_FLAG.value, _ATTRIBUTION_ARMED
    index_model(layer)
    with _state_lock:
        _last_attribution = None
    _NAN_FLAG.value = True
    set_eager_check(True)
    _tls.stack = []
    try:
        with torch.no_grad():
            if state is None:
                out = layer(*arrs[:-1])
            else:
                out = torch.func.functional_call(layer, state,
                                                 tuple(arrs[:-1]))
            loss_fn(out, arrs[-1])
    except Exception:
        pass  # FloatingPointError: note_bad_tensor recorded it; anything
        # else: the replay is best-effort and never takes down training
    finally:
        _NAN_FLAG.value = prev_flag
        set_eager_check(prev_armed)
    with _state_lock:
        return dict(_last_attribution) if _last_attribution else None


# arm the per-op check if the flag was set in the environment before this
# module loaded (flags.py forwards later runtime changes)
if _NAN_FLAG.value:
    set_eager_check(True)


# ---------------------------------------------------------------------------
# tier 3: trend detection + auto-response
# ---------------------------------------------------------------------------
class HealthMonitor:
    """hapi callback: loss-spike / divergence / grad-explosion / vanishing
    / stagnation detection over the sentinel stats (or, without a
    sentinel, the per-batch loss logs), with the configured auto-response
    on confirmed divergence.

    Usage::

        model.fit(..., callbacks=[
            FaultTolerantCheckpoint(dirname, save_freq_steps=50),
            HealthMonitor(action="rollback", checkpoint=dirname)])

    Detection:
      * nonfinite loss/grads (sentinel trip or a NaN/Inf loss log) —
        immediately CONFIRMED divergence;
      * loss spike: EWMA mean/variance z-score above ``z_threshold`` for
        ``confirm_steps`` consecutive steps — CONFIRMED divergence;
      * grad explosion (norm > ``explode_factor`` x its EWMA), vanishing
        (norm < ``vanish_threshold`` for ``vanish_steps``), stagnation
        (relative EWMA loss change < ``stagnation_rel`` over
        ``stagnation_steps``) — warn-level alerts only.

    Response (``action``, default from ``PADDLE_TPU_HEALTH_ACTION``):
      * ``warn``     — the ``health_alert`` event only;
      * ``halt``     — set ``model.stop_training`` (fit stops at the next
        batch boundary);
      * ``rollback`` — restore the last VALID checkpoint (model +
        optimizer + TrainStep slots + RNG) through `checkpoint` (a
        ``FaultTolerantCheckpoint`` callback, a ``CheckpointManager``, or
        a directory path), count ``health_rollback_total``, and keep
        training. The restore is what a fresh ``fit(resume=)`` from the
        same file loads. ``cooldown_steps`` suppresses re-detection while
        the EWMA re-converges; after ``max_rollbacks`` the monitor
        degrades to halt;
      * ``fleet``    — the fleet-wide coordinated rollback needs the fleet
        controller, which the port does not have yet (ROADMAP A11/A12):
        constructing a monitor with it raises.
    """

    def __init__(self, action: Optional[str] = None, window: int = 50,
                 z_threshold: float = 6.0, confirm_steps: int = 3,
                 explode_factor: float = 1000.0,
                 vanish_threshold: float = 1e-10, vanish_steps: int = 20,
                 stagnation_steps: int = 0, stagnation_rel: float = 1e-4,
                 checkpoint=None, cooldown_steps: int = 50,
                 max_rollbacks: int = 3):
        self.action = (action or globals()["action"]()).lower()
        if self.action not in ("warn", "halt", "rollback", "fleet"):
            raise ValueError(f"unknown health action {self.action!r} "
                             f"(expected warn | halt | rollback | fleet)")
        if self.action == "fleet":
            raise NotImplementedError(
                "HealthMonitor(action='fleet'): the fleet controller is not "
                "ported yet (ROADMAP A11/A12)")
        self.window = max(int(window), 2)
        self.z_threshold = float(z_threshold)
        self.confirm_steps = max(int(confirm_steps), 1)
        self.explode_factor = float(explode_factor)
        self.vanish_threshold = float(vanish_threshold)
        self.vanish_steps = max(int(vanish_steps), 1)
        self.stagnation_steps = int(stagnation_steps)  # 0 = disabled
        self.stagnation_rel = float(stagnation_rel)
        self.checkpoint = checkpoint
        self.cooldown_steps = max(int(cooldown_steps), 0)
        self.max_rollbacks = max(int(max_rollbacks), 0)
        self.model = None
        self.params = {}
        self.alerts: List[dict] = []
        self.rollbacks = 0
        self._reset_detectors()
        self._global_step = 0
        self._last_seen_stats_ts = None
        self._cooldown_until = -1

    # -- hapi protocol -------------------------------------------------------
    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model
        index_model(getattr(model, "network", model))

    def _reset_detectors(self):
        self._ewma_loss = None
        self._ewma_var = 0.0
        self._ewma_grad = None
        self._n_obs = 0  # losses observed since the last (re)baseline
        self._spike_streak = 0
        self._vanish_streak = 0
        self._stagnation_anchor = None  # (step, ewma_loss)

    def on_train_begin(self, logs=None):
        self._global_step = 0
        self._reset_detectors()

    def on_train_batch_end(self, step, logs=None):
        self._global_step += 1
        stats = last_stats()
        fresh = (stats is not None
                 and stats.get("ts") != self._last_seen_stats_ts)
        if fresh:
            self._last_seen_stats_ts = stats.get("ts")
        loss = None
        grad_norm = None
        nonfinite = False
        if fresh:
            loss = stats.get("loss")
            grad_norm = _f(stats.get("grad_norm"))
            nonfinite = bool(stats.get("nonfinite"))
        elif isinstance(logs, dict) and logs.get("loss") is not None:
            try:
                loss = float(np.asarray(logs["loss"]).ravel()[0])
            except Exception:
                loss = None
        self.observe(loss=loss, grad_norm=grad_norm, nonfinite=nonfinite,
                     step=self._global_step)

    # unused hooks (hapi CallbackList calls them all)
    def on_train_end(self, logs=None): pass
    def on_epoch_begin(self, epoch, logs=None): pass
    def on_epoch_end(self, epoch, logs=None): pass
    def on_eval_begin(self, logs=None): pass
    def on_eval_end(self, logs=None): pass
    def on_predict_begin(self, logs=None): pass
    def on_predict_end(self, logs=None): pass
    def on_train_batch_begin(self, step, logs=None): pass
    def on_eval_batch_begin(self, step, logs=None): pass
    def on_eval_batch_end(self, step, logs=None): pass
    def on_predict_batch_begin(self, step, logs=None): pass
    def on_predict_batch_end(self, step, logs=None): pass

    # -- detection -----------------------------------------------------------
    def observe(self, loss: Optional[float] = None,
                grad_norm: Optional[float] = None,
                nonfinite: bool = False, step: Optional[int] = None):
        """Feed one step's signals (also the manual-loop entry point).
        Runs the detectors and, on confirmed divergence, the response."""
        if step is None:
            self._global_step += 1
            step = self._global_step
        else:
            self._global_step = int(step)
        if step <= self._cooldown_until:
            return
        warned = False
        if loss is not None:
            try:
                loss = float(loss)
            except (TypeError, ValueError):
                loss = None
            else:
                if not math.isfinite(loss):
                    nonfinite = True
        if nonfinite:
            self._alert("nonfinite", step, severity="error",
                        loss=_f(loss), grad_norm=_f(grad_norm))
            self._respond("nonfinite", step)
            self._after_response(step)
            return
        if loss is not None and math.isfinite(loss):
            warned |= self._observe_loss(float(loss), step)
        if grad_norm is not None and math.isfinite(grad_norm):
            warned |= self._observe_grad(float(grad_norm), step)
        if not warned and not tripped() and \
                last_status() in ("warn", "diverged"):
            # a clean step re-arms the status; while the sentinel IS
            # tripped it stays authoritative
            set_status("ok")

    def _observe_loss(self, loss: float, step: int) -> bool:
        alpha = 2.0 / (self.window + 1.0)
        warned = False
        self._n_obs += 1
        if self._ewma_loss is None:
            self._ewma_loss = loss
            self._ewma_var = 0.0
        else:
            dev = loss - self._ewma_loss
            # std floor relative to the loss level (plus an absolute
            # epsilon); the warmup gate counts losses observed since the
            # last (re)baseline
            std = max(math.sqrt(max(self._ewma_var, 0.0)),
                      1e-3 * abs(self._ewma_loss), 1e-9)
            z = dev / std
            if z > self.z_threshold and self._n_obs > self.window // 2:
                self._spike_streak += 1
                if self._spike_streak >= self.confirm_steps:
                    self._alert("loss_spike", step, severity="error",
                                loss=loss, z=round(z, 2),
                                ewma=round(self._ewma_loss, 6))
                    self._respond("loss_spike", step)
                    self._after_response(step)
                    return True
                warned = True
                self._alert("loss_spike_suspect", step, severity="warn",
                            loss=loss, z=round(z, 2),
                            streak=self._spike_streak)
                # a suspected outlier stays out of the EWMA baseline
            else:
                self._spike_streak = 0
                self._ewma_var = (1 - alpha) * (
                    self._ewma_var + alpha * dev * dev)
                self._ewma_loss += alpha * dev
        if self.stagnation_steps > 0:
            if self._stagnation_anchor is None:
                self._stagnation_anchor = (step, self._ewma_loss)
            else:
                a_step, a_loss = self._stagnation_anchor
                if step - a_step >= self.stagnation_steps:
                    denom = max(abs(a_loss), 1e-12)
                    if abs(self._ewma_loss - a_loss) / denom < \
                            self.stagnation_rel:
                        warned = True
                        self._alert("stagnation", step, severity="warn",
                                    ewma=round(self._ewma_loss, 6),
                                    over_steps=step - a_step)
                    self._stagnation_anchor = (step, self._ewma_loss)
        return warned

    def _observe_grad(self, norm: float, step: int) -> bool:
        warned = False
        if self._ewma_grad is not None and self._ewma_grad > 0 and \
                norm > self.explode_factor * self._ewma_grad:
            warned = True
            self._alert("grad_explosion", step, severity="warn",
                        grad_norm=norm,
                        ewma=round(self._ewma_grad, 9))
        if norm < self.vanish_threshold:
            self._vanish_streak += 1
            if self._vanish_streak == self.vanish_steps:
                warned = True
                self._alert("grad_vanishing", step, severity="warn",
                            grad_norm=norm, streak=self._vanish_streak)
        else:
            self._vanish_streak = 0
        alpha = 2.0 / (self.window + 1.0)
        self._ewma_grad = norm if self._ewma_grad is None else \
            (1 - alpha) * self._ewma_grad + alpha * norm
        return warned

    def _alert(self, signal: str, step: int, severity: str = "warn",
               **payload):
        rec = {"signal": signal, "step": int(step), "severity": severity}
        rec.update(payload)
        self.alerts.append(rec)
        note_alert(rec)
        if severity == "error":
            set_status("diverged")
        elif last_status() != "diverged":
            set_status("warn")
        try:
            if _metrics_mod.enabled():
                _M_ALERTS.inc(signal=signal)
            _events_mod.emit("health_alert", severity=severity, **rec)
        except Exception:
            pass

    def _after_response(self, step: int):
        """Re-baseline after any confirmed response and hold detection
        off for the cooldown window."""
        self._reset_detectors()
        self._cooldown_until = max(self._cooldown_until,
                                   step + self.cooldown_steps)

    # -- response ------------------------------------------------------------
    def _respond(self, reason: str, step: int):
        if self.action == "halt":
            self._halt(reason, step)
        elif self.action == "rollback":
            self._rollback(reason, step)
        # warn: the alert event above is the whole response

    def _halt(self, reason: str, step: int):
        if self.model is not None:
            self.model.stop_training = True
        _events_mod.emit("health_alert", severity="error", signal="halt",
                         reason=reason, step=int(step))

    def _resolve_manager(self):
        ckpt = self.checkpoint
        if ckpt is None:
            return None
        from ..distributed.checkpoint import CheckpointManager, open_manager
        if isinstance(ckpt, CheckpointManager):
            return ckpt
        if hasattr(ckpt, "manager"):  # FaultTolerantCheckpoint callback
            return ckpt.manager
        return open_manager(str(ckpt))

    def _load_numerically_valid(self, mgr, step: int):
        """(blob, ckpt_step) of the newest checkpoint whose NETWORK params
        are all finite, walking back past newer files that captured
        already-poisoned state."""
        from ..distributed.checkpoint import load as _load_ckpt
        from ..distributed.checkpoint import tree_finite
        found = mgr.load_latest()
        if found is None:
            return None
        blob, ckpt_step = found
        if tree_finite(blob.get("network") if isinstance(blob, dict)
                       else None):
            return blob, ckpt_step
        self._alert("rollback_skip_nonfinite", step, severity="warn",
                    skipped_step=int(ckpt_step))
        for s in sorted((s for s in mgr.steps() if s < ckpt_step),
                        reverse=True):
            try:
                blob2 = _load_ckpt(mgr.path_for(s))
            except Exception:
                continue
            if tree_finite(blob2.get("network")):
                return blob2, s
            self._alert("rollback_skip_nonfinite", step, severity="warn",
                        skipped_step=int(s))
        return None

    def _rollback(self, reason: str, step: int):
        """Restore the last numerically-valid checkpoint into the live
        model — exactly what a fresh fit(resume=) would load — and keep
        training. Degrades to halt when no checkpoint is reachable or the
        rollback budget is spent."""
        if self.max_rollbacks and self.rollbacks >= self.max_rollbacks:
            self._alert("rollback_budget_exhausted", step, severity="error",
                        rollbacks=self.rollbacks)
            self._halt(reason, step)
            return
        try:
            mgr = self._resolve_manager()
            found = self._load_numerically_valid(mgr, step) \
                if mgr is not None else None
        except Exception as e:
            found = None
            self._alert("rollback_failed", step, severity="error",
                        error=f"{type(e).__name__}: {e}")
        if found is None:
            self._alert("rollback_unavailable", step, severity="error",
                        reason=reason)
            self._halt(reason, step)
            return
        blob, ckpt_step = found
        m = self.model
        if m is None or not isinstance(blob, dict) or "network" not in blob:
            self._alert("rollback_failed", step, severity="error",
                        error="no model attached" if m is None
                        else "checkpoint blob has no 'network' state")
            self._halt(reason, step)
            return
        try:
            m._restore_blob(blob)
        except Exception as e:
            self._alert("rollback_failed", step, severity="error",
                        error=f"{type(e).__name__}: {e}")
            self._halt(reason, step)
            return
        self.rollbacks += 1
        note_rollback()
        clear_trip()
        set_status("ok")
        self._reset_detectors()
        self._cooldown_until = step + self.cooldown_steps
        try:
            if _metrics_mod.enabled():
                _M_ROLLBACK.inc()
            _events_mod.emit("health_rollback", severity="warn",
                             reason=reason, step=int(step),
                             restored_step=int(ckpt_step),
                             rollbacks=self.rollbacks)
        except Exception:
            pass
