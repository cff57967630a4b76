"""The engine helpers the pipeline reads (counterpart of the functions of
``paddle_tpu/distributed/meta_parallel/engine.py`` that
``pipeline_parallel.py`` imports, l.49-51).

The reference's helpers build sharding specs and in-graph updates for
one compiled SPMD program. The port runs one process a rank, which holds
its own pipeline stage: there is no spec to filter (``_filter_spec``)
and no slot to place (``_slot_shardings``), since a rank builds masters
and slots for its stage alone. What is left: reading a strategy, the
rank grid's axis sizes, fp16 dynamic loss scaling with the update
skipped on a non-finite gradient, and the health sentinel.
``HybridParallelTrainStep`` (``engine.py:191``) is not ported (ROADMAP
A11 item 2).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ...profiler import health as _health_mod


def _axis_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a rank grid (``topology.RankGrid``)."""
    return dict(mesh.shape)


def _data_axes_of(sizes) -> Optional[Tuple[str, ...]]:
    """The axes the batch is split over (dp, then sharding), or None."""
    return tuple(a for a in ("dp", "sharding")
                 if sizes.get(a, 1) > 1) or None


def _parse_strategy(strategy, sizes):
    """(amp_enabled, amp_dtype, recompute, sharding_stage, accum_steps),
    the amp dtype a torch dtype (bf16 unless the strategy says
    "float16")."""
    amp_enabled = bool(strategy and strategy.amp)
    amp_dtype = torch.bfloat16 if not strategy else (
        torch.float16 if strategy.amp_configs.get("dtype") == "float16"
        else torch.bfloat16)
    recompute = bool(strategy and strategy.recompute)
    sharding_stage = 0
    if strategy and strategy.sharding:
        sharding_stage = int(strategy.sharding_configs.get("stage", 1))
    if sizes.get("sharding", 1) > 1 and sharding_stage == 0:
        sharding_stage = 1
    accum = 1
    if strategy is not None:
        if strategy.gradient_merge:
            accum = int(strategy.gradient_merge_configs.get("k_steps", 1))
        elif strategy.pipeline:
            accum = int(strategy.pipeline_configs.get("accumulate_steps", 1))
    return amp_enabled, amp_dtype, recompute, sharding_stage, max(1, accum)


def _scaler_config(strategy) -> dict:
    """fp16 dynamic loss scaling's settings (reference
    ``grad_scaler.py:26``), from the strategy's amp configs."""
    cfg = strategy.amp_configs if strategy is not None else {}
    return {
        "init_scale": float(cfg.get("init_loss_scaling", 2.0 ** 15)),
        "incr_every": int(cfg.get("incr_every_n_steps", 1000)),
        "incr_ratio": float(cfg.get("incr_ratio", 2.0)),
        "decr_ratio": float(cfg.get("decr_ratio", 0.5)),
    }


@torch.no_grad()
def _apply_scaled_update(optimizer, params: dict, grads: dict,
                         opt_state: dict, lr, t, scaler_state: dict,
                         sc: dict, finite_all: Callable = None,
                         **apply_kw) -> bool:
    """Unscale ``grads`` in place, and update ``params`` and ``opt_state``
    in place only if every gradient is finite; move the dynamic scale
    (``scaler_state``: {"scale": float, "good": int}) as the reference's
    fused check_finite_and_unscale/update_loss_scaling does. ``finite_all``
    turns this process's finite flag (a 0-d float tensor, 1 when finite)
    into the whole job's (one stage's inf skips every stage's update).
    Returns whether the update ran."""
    scale = scaler_state["scale"]
    gs = list(grads.values())
    torch._foreach_mul_(gs, 1.0 / scale)
    dev = gs[0].device
    bad = torch.zeros((), dtype=torch.float32, device=dev)
    for g in gs:
        bad += (~torch.isfinite(g)).any().float()
    flag = (bad == 0).float()
    if finite_all is not None:
        flag = finite_all(flag)
    finite = bool(flag.item())
    if finite:
        optimizer.apply_fn(params, grads, opt_state, lr=lr, t=t,
                           inplace=True, **apply_kw)
    good = scaler_state["good"]
    grew = finite and good + 1 >= sc["incr_every"]
    if finite:
        scaler_state["scale"] = scale * sc["incr_ratio"] if grew else scale
        scaler_state["good"] = 0 if grew else good + 1
    else:
        scaler_state["scale"] = max(scale * sc["decr_ratio"], 1.0)
        scaler_state["good"] = 0
    return finite


def _build_health_probe(params: Dict[str, object], health):
    """(probe or None, interval): the step sentinel over ``params``;
    ``health=None`` follows PADDLE_TPU_HEALTH / FLAGS_check_nan_inf as
    ``jit.TrainStep`` does."""
    if health is None:
        health = _health_mod.enabled()
    probe = _health_mod.HealthProbe(params) if health else None
    return probe, _health_mod.interval()


def _health_grads(grads: dict, scaler_state: dict, fp16: bool) -> dict:
    """The gradients as the sentinel reads them: under fp16 loss scaling
    unscaled, with non-finite lanes as 0 (an overflow is the scaler's
    signal, not a divergence); bf16 and fp32 ones as they are."""
    if not fp16:
        return grads
    inv = 1.0 / scaler_state["scale"]
    return {k: torch.where(torch.isfinite(g), g * inv, torch.zeros_like(g))
            for k, g in grads.items()}


def _note_health(step_obj, hvec) -> None:
    """Decode and record one sentinel vector as ``step_obj.last_health``.
    Never raises."""
    try:
        stats = step_obj._health_probe.decode(hvec.cpu().numpy())
        step_obj.last_health = _health_mod.record_step_stats(
            stats, step=step_obj._t, source="sentinel")
    except Exception:
        pass
