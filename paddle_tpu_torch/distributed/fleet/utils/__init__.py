"""fleet.utils — activation recomputation (counterpart of
``paddle_tpu/distributed/fleet/utils/__init__.py``, whose ``recompute``
wraps the region in ``jax.checkpoint``).

``recompute(function, *args)`` runs ``function`` under
``torch.utils.checkpoint`` (non-reentrant): the region's activations are
not kept, and the backward replays its forward to rebuild them. As in the
reference, the layers the region uses are found from ``function`` itself,
its ``__self__``, a ``functools.partial``'s payload and its closure cells;
their parameters enter the region as explicit inputs and, with their
buffers as they were at the call, are swapped in while it runs. That
matters under ``jit.TrainStep``: the step runs the model on bf16 casts of its masters through
``torch.func.functional_call``, and takes the gradients after that call
has restored the module's own parameters; a replay that read the
module's attributes would recompute from the fp32 masters. Passing the
tensors in use at call time keeps the replay on the casts.

Batch-norm running statistics move once, in the forward: the replay swaps
in throwaway copies of the buffers, so what it moves is discarded (the
reference carries them out of its region for the same reason). The replay
runs under the data-parallel batch-norm group of the call
(``distributed.parallel.bn_scope``), so it recomputes the statistics the
forward took.

``policy``: None recomputes the whole region; ``recompute_policies.dots``
(the counterpart of ``jax.checkpoint_policies.
dots_with_no_batch_dims_saveable``) saves the outputs of the products
without batch dimensions, ``aten.mm`` and ``aten.addmm``, and recomputes
everything else, through ``torch.utils.checkpoint``'s selective
checkpointing. The hand-written kernels write through ctypes into tensors
that a dispatch mode cannot see, so no policy may save a kernel's output:
the Functions that launch them (layer norm, flash attention) run again in
the replay, as the reference re-runs its custom-vjp flash forward under
both policies.
"""
from __future__ import annotations

import contextlib
import functools
from typing import List

import torch
from torch.utils import checkpoint as _ckpt

from ... import parallel as _parallel

__all__ = ["recompute", "recompute_policies"]


class recompute_policies:
    """Selective-checkpoint policies for ``recompute(policy=...)``."""

    _DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    @staticmethod
    def dots(ctx, op, *args, **kwargs):
        """Save the outputs of products without batch dimensions (``mm``,
        ``addmm``); recompute everything else."""
        if op in recompute_policies._DOTS:
            return _ckpt.CheckpointPolicy.MUST_SAVE
        return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _collect_layers(function) -> List[torch.nn.Module]:
    """Modules reachable from `function`: itself, its bound owner, a
    functools.partial's payload, its closure cells (one level, as the
    reference)."""
    found: List[torch.nn.Module] = []

    def add(obj):
        if isinstance(obj, torch.nn.Module) and all(obj is not m
                                                    for m in found):
            found.append(obj)

    add(function)
    add(getattr(function, "__self__", None))
    if isinstance(function, functools.partial):
        add(function.func)
        add(getattr(function.func, "__self__", None))
        for a in (*function.args, *function.keywords.values()):
            add(a)
    for cell in getattr(function, "__closure__", None) or ():
        try:
            add(cell.cell_contents)
        except ValueError:  # an empty cell
            pass
    return found


def _slots(layer: torch.nn.Module, kind: str):
    """[(dict, key)] of every parameter (kind "_parameters") or buffer
    ("_buffers") of `layer`, where its module keeps it (the slots
    ``functional_call`` swaps too)."""
    return [(store, k) for mod in layer.modules()
            for store in (getattr(mod, kind),)
            for k, t in store.items() if t is not None]


@contextlib.contextmanager
def _swapped(slots, tensors):
    """Each slot holds its tensor of `tensors` while inside."""
    saved = [store[k] for store, k in slots]
    try:
        for (store, k), t in zip(slots, tensors):
            store[k] = t
        yield
    finally:
        for (store, k), t in zip(slots, saved):
            store[k] = t


def _contexts(policy, live, buffers):
    """checkpoint's context_fn: (forward context, replay context). The
    replay context points ``live["buffers"]`` at copies of `buffers` while
    the region runs again."""
    @contextlib.contextmanager
    def replaying(ctx):
        with torch.no_grad():
            live["buffers"] = [b.clone() for b in buffers]
        try:
            with ctx:
                yield
        finally:
            live["buffers"] = buffers

    def fn():
        if policy is None:
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
        else:
            fwd, rec = _ckpt.create_selective_checkpoint_contexts(policy)
        return fwd, replaying(rec)
    return fn


def recompute(function, *args, preserve_rng_state: bool = True,
              use_reentrant: bool = True, policy=None, **kwargs):
    """Run ``function(*args, **kwargs)`` without keeping its activations;
    the backward re-runs it (reference ``recompute.py:199`` semantics).

    ``preserve_rng_state`` replays dropout's masks from the RNG state at
    the call. ``use_reentrant`` is accepted for the reference's signature
    and ignored: the region always runs non-reentrant, since the reentrant
    form gives no gradients under ``torch.autograd.grad``, which
    ``jit.TrainStep`` uses. ``policy``: None (recompute all) or a
    selective-checkpoint policy such as ``recompute_policies.dots``."""
    del use_reentrant
    layers = _collect_layers(function)
    p_slots = [s for layer in layers for s in _slots(layer, "_parameters")]
    b_slots = [s for layer in layers for s in _slots(layer, "_buffers")]
    params = [store[k] for store, k in p_slots]
    # buffers ride in the closure: a checkpoint input saved for the backward
    # must not change, and batch norm moves its statistics in place
    buffers = [store[k] for store, k in b_slots]
    live = {"buffers": buffers}
    n = len(params)
    bn_group = _parallel.bn_group()

    def region(*flat, **kw):
        with _swapped(p_slots + b_slots, list(flat[:n]) + live["buffers"]), \
                _parallel.bn_scope(bn_group):
            return function(*flat[n:], **kw)

    return _ckpt.checkpoint(region, *params, *args, use_reentrant=False,
                            preserve_rng_state=preserve_rng_state,
                            context_fn=_contexts(policy, live, buffers),
                            **kwargs)
