"""Fused softmax cross-entropy (hard labels): the CUDA kernels
``csrc/softmax_ce.cu``, their plain PyTorch versions, and the autograd
Function that carries them.

Replaces ``paddle_tpu/ops/pallas/softmax_ce.py``: ``_ce_fwd_pallas``
(online logsumexp and label pick, giving nll and lse [N] fp32) and
``_ce_bwd_pallas`` (dlogits = (softmax - onehot) * dnll written in the
logits' type, with no fp32 [N, V] intermediate). Both are bound by bytes;
one block per row, 16-byte loads where the row allows them, fp32
arithmetic. See the source for the design.

``SoftmaxCEFunction`` is the counterpart of the ``_fused_ce`` custom vjp
(l.302-329) and ``fused_softmax_ce`` of the entry at l.349. An
out-of-range label (``ignore_index`` -100, or V) gives nll = lse and a
row gradient of softmax * dnll, as the reference's does; the caller masks
both. The TPU's eligibility gate (V >= 4096, N >= 64, default off on the
v5e; l.314-335) was shaped by Mosaic and its measurements there and does
not carry over: every hard-label, unweighted, last-axis loss takes this
Function.
"""
from __future__ import annotations

import torch

from . import launch, same_device, use_kernel

#: forward launches (and runs of its plain version)
_stats = {"kernel": 0, "plain": 0}
#: backward launches (and runs of its plain version)
_bwd_stats = {"kernel": 0, "plain": 0}

_TYPES = (torch.float32, torch.bfloat16)


def softmax_ce_fwd_plain(logits2d, labels):
    """(nll [N] fp32, lse [N] fp32) of logits [N, V] and hard labels [N];
    an out-of-range label picks nothing, so its nll is lse."""
    x = logits2d.float()
    V = x.shape[-1]
    lse = torch.logsumexp(x, dim=-1)
    labels = labels.long()
    valid = (labels >= 0) & (labels < V)
    picked = x.gather(1, labels.clamp(0, V - 1)[:, None])[:, 0]
    return lse - torch.where(valid, picked, 0.0), lse


def softmax_ce_bwd_plain(logits2d, labels, lse, dnll):
    """dlogits = (exp(logits - lse) - onehot(label)) * dnll in the logits'
    type (an out-of-range label has no one-hot column)."""
    V = logits2d.shape[-1]
    p = torch.exp(logits2d.float() - lse[:, None])
    cols = torch.arange(V, device=logits2d.device)
    onehot = (cols[None, :] == labels.long()[:, None]).float()
    return ((p - onehot) * dnll.float()[:, None]).to(logits2d.dtype)


def check_args(logits2d, labels) -> None:
    """What the CUDA kernels take; raises ValueError on anything else."""
    same_device("softmax_ce", logits2d, labels)
    if logits2d.dim() != 2 or not logits2d.is_contiguous():
        raise ValueError("softmax_ce: logits must be a contiguous [N, V] "
                         "tensor")
    if logits2d.dtype not in _TYPES:
        raise ValueError(f"softmax_ce: logits type {logits2d.dtype}; the "
                         f"kernels take float32 and bfloat16")
    N, V = logits2d.shape
    if labels.dtype != torch.int32 or labels.shape != (N,) \
            or not labels.is_contiguous():
        raise ValueError(f"softmax_ce: labels must be contiguous int32 "
                         f"[{N}], got {labels.dtype} {tuple(labels.shape)}")
    if not 1 <= V < 2 ** 31 or N >= 2 ** 31:
        raise ValueError(f"softmax_ce: N {N}, V {V} out of range")


def softmax_ce_fwd(logits2d, labels):
    """(nll [N] fp32, lse [N] fp32) of logits [N, V] and labels [N]."""
    if not use_kernel(logits2d):
        _stats["plain"] += 1
        return softmax_ce_fwd_plain(logits2d, labels)
    check_args(logits2d, labels)
    N, V = logits2d.shape
    nll = torch.empty(N, dtype=torch.float32, device=logits2d.device)
    lse = torch.empty_like(nll)
    if N == 0:
        return nll, lse
    launch("softmax_ce_fwd", "pt_softmax_ce_fwd", logits2d.device,
           logits2d.data_ptr(), labels.data_ptr(), nll.data_ptr(),
           lse.data_ptr(), N, V, int(logits2d.dtype == torch.bfloat16))
    _stats["kernel"] += 1
    return nll, lse


def softmax_ce_bwd(logits2d, labels, lse, dnll):
    """dlogits [N, V] in the logits' type."""
    if not use_kernel(logits2d):
        _bwd_stats["plain"] += 1
        return softmax_ce_bwd_plain(logits2d, labels, lse, dnll)
    check_args(logits2d, labels)
    same_device("softmax_ce_bwd", logits2d, lse, dnll)
    N, V = logits2d.shape
    # dnll from nll.sum() or .mean() arrives expanded, with stride 0
    lse = lse.float().contiguous()
    dnll = dnll.float().contiguous()
    if lse.shape != (N,) or dnll.shape != (N,):
        raise ValueError(f"softmax_ce_bwd: lse {tuple(lse.shape)} and dnll "
                         f"{tuple(dnll.shape)} must be [{N}]")
    dlogits = torch.empty_like(logits2d)
    if N == 0:
        return dlogits
    launch("softmax_ce_bwd", "pt_softmax_ce_bwd", logits2d.device,
           logits2d.data_ptr(), labels.data_ptr(), lse.data_ptr(),
           dnll.data_ptr(), dlogits.data_ptr(), N, V,
           int(logits2d.dtype == torch.bfloat16))
    _bwd_stats["kernel"] += 1
    return dlogits


class SoftmaxCEFunction(torch.autograd.Function):
    """nll [N] fp32 of logits [N, V] and hard labels [N]; the backward
    recomputes the softmax from the saved lse."""

    @staticmethod
    def forward(ctx, logits2d, labels):
        nll, lse = softmax_ce_fwd(logits2d, labels)
        ctx.save_for_backward(logits2d, labels, lse)
        return nll

    @staticmethod
    def backward(ctx, dnll):
        logits2d, labels, lse = ctx.saved_tensors
        return softmax_ce_bwd(logits2d, labels, lse, dnll), None


def fused_softmax_ce(logits, labels):
    """nll [*batch] fp32 for hard labels over the last axis of ``logits``.
    Out-of-range labels give a finite nll (= lse) for the caller to mask;
    a zero cotangent for those rows then zeroes their gradient."""
    shape = logits.shape[:-1]
    flat = logits.reshape(-1, logits.shape[-1]).contiguous()
    flab = labels.reshape(-1)
    if flat.is_cuda:
        flab = flab.to(torch.int32).contiguous()
    return SoftmaxCEFunction.apply(flat, flab).reshape(shape)
