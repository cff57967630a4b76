"""BatchNorm statistics shared by the unfused train path (``nn/functional``)
and the fused BN family (``ops/kernels/fused_bn``, ``fused_conv_bn``).

The port's own copy of ``paddle_tpu/ops/_bn_common.py``: one definition,
so the fused paths' running statistics agree with the unfused path's.

Under data parallelism the reference's statistics are those of the global
batch (one controller: its mean runs over the dp-sharded array). The port
runs one process a rank, so while a data-parallel group is in force
(:func:`bn_scope`, which ``distributed.parallel`` enters for a
``DataParallel`` forward or a grouped ``TrainStep`` step) the per-channel
moments are summed over the group: :func:`group_stats` (one all-reduce a
batch norm, counted as ``"bn_sync"`` in ``collective.launch_stats()``)
and, in a backward, :func:`group_sums`.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

#: the kind the group's batch-norm all-reduces count under
BN_SYNC = "bn_sync"

#: [group or None]: the data-parallel group batch norm takes its statistics
#: over, innermost last (a recomputed region's replay puts back the group of
#: its forward)
_bn_scope: list = []


def bn_group():
    """The group of the batch-norm scope in force, or None."""
    return _bn_scope[-1] if _bn_scope else None


@contextlib.contextmanager
def bn_scope(group):
    """Batch norms in training mode take ``group``'s statistics (None: this
    process's batch) while the block runs."""
    _bn_scope.append(group)
    try:
        yield
    finally:
        _bn_scope.pop()


def _bn_axes(x, data_format):
    """(axes reduced over, broadcast shape of a per-channel vector)."""
    c_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != c_axis)
    shape = [1] * x.dim()
    shape[c_axis] = x.shape[c_axis]
    return axes, shape


def _rows(x, axes) -> int:
    """Elements of ``x`` each channel's statistics run over."""
    n = 1
    for a in axes:
        n *= x.shape[a]
    return n


def _bn_moments(x, axes):
    """fp32 (E[x], E[x^2]) over `axes`."""
    xf = x.float()
    return xf.mean(dim=axes), (xf * xf).mean(dim=axes)


def _var(mean, mean2):
    """E[x^2] - E[x]^2 clamped at 0."""
    return torch.clamp(mean2 - mean * mean, min=0.0)


def _bn_stats(x, axes):
    """One-pass fp32 statistics: mean = E[x], var = E[x^2] - E[x]^2
    clamped at 0 (the reference's formula, l.22-30)."""
    mean, mean2 = _bn_moments(x, axes)
    return mean, _var(mean, mean2)


class Sync(NamedTuple):
    """What a batch norm's forward took its statistics over, kept in its
    ``ctx`` for the backward (which looks up no scope): the group, and
    ``share``, the fp32 0-d ``rows / N`` of this rank's rows over the
    group's (exactly 1 in a world of one)."""
    group: object
    share: torch.Tensor


def _all_reduce(buf, group):
    from ..distributed import collective
    collective.raw_all_reduce(buf, group, kind=BN_SYNC)


def group_moments(mean, mean2, rows: int, group):
    """(E[x], E[x^2], Sync) of the group's batch from this rank's fp32
    moments over its ``rows`` rows. One in-place all-reduce of fp64
    ``[rows * mean, rows * mean2, rows]``: the products are exact in fp64
    (a 24-bit significand times a count below 2^29) and so is the count
    (below 2^53), so uneven shards weigh by their rows and a world of one
    gives back this rank's moments bit for bit."""
    C = mean.shape[0]
    buf = torch.empty(2 * C + 1, dtype=torch.float64, device=mean.device)
    buf[:C].copy_(mean)
    buf[C:2 * C].copy_(mean2)
    buf[:2 * C].mul_(rows)
    buf[2 * C:].fill_(rows)
    _all_reduce(buf, group)
    total = buf[2 * C]
    sums = buf[:2 * C] / total
    share = (torch.full_like(total, rows) / total).float()
    return sums[:C].float(), sums[C:].float(), Sync(group, share)


def group_stats(x, axes, group):
    """(mean, var, sync) of the batch norm's input ``x`` over ``axes``:
    this rank's statistics (:func:`_bn_stats`) and None when ``group`` is
    None, else the group's (:func:`group_moments`)."""
    if group is None:
        return (*_bn_stats(x, axes), None)
    mean, mean2 = _bn_moments(x, axes)
    mean, mean2, sync = group_moments(mean, mean2, _rows(x, axes), group)
    return mean, _var(mean, mean2), sync


def group_sums(sync: Optional[Sync], *vecs):
    """A backward's per-channel sums over this rank's ``rows`` rows (its
    column sums, the cotangents of the statistics; None passes through),
    made the group's for the forward's ``sync``: summed over the group in
    one in-place all-reduce and scaled by ``rows / N``. So the caller
    divides by its own ``rows`` either way and gets the forward's batch's
    per-row values; with ``sync`` None the vectors come back unchanged."""
    if sync is None:
        return vecs
    live = [v.float() for v in vecs if v is not None]
    buf = torch.cat(live)
    _all_reduce(buf, sync.group)
    buf.mul_(sync.share)
    out, off = [], 0
    for v in vecs:
        if v is None:
            out.append(None)
            continue
        out.append(buf[off:off + v.numel()])
        off += v.numel()
    return out


class _GroupMoments(torch.autograd.Function):
    """group_moments with a gradient: the cotangents of the group's
    moments are summed over the group (every rank's loss reads them) and
    scaled by ``rows / N``, the weight of this rank's moments in them."""

    @staticmethod
    def forward(ctx, mean, mean2, rows, group):
        gmean, gmean2, ctx.sync = group_moments(mean, mean2, rows, group)
        return gmean, gmean2

    @staticmethod
    def backward(ctx, dmean, dmean2):
        dmean, dmean2 = group_sums(ctx.sync, dmean, dmean2)
        return dmean, dmean2, None, None


def group_stats_differentiable(x, axes, group):
    """(mean, var) of :func:`group_stats` through autograd (the composed
    routes): with a group, gradients flow to every rank's rows through the
    group's moments."""
    if group is None:
        return _bn_stats(x, axes)
    mean, mean2 = _bn_moments(x, axes)
    mean, mean2 = _GroupMoments.apply(mean, mean2, _rows(x, axes), group)
    return mean, _var(mean, mean2)
