"""The functionals of the serving and training slices (counterpart of
``paddle_tpu/nn/functional/__init__.py``): ``linear`` (l.228),
``embedding`` (l.244), ``gelu`` (l.80), ``dropout`` (l.270),
``layer_norm`` (l.534), ``scaled_dot_product_attention`` (l.1285) and
``cross_entropy`` (l.897).

Layer norm, attention and the hard-label softmax cross-entropy go to the
hand-written kernels of ``ops/kernels`` (on a CUDA tensor) or their plain
versions (on a CPU tensor), through autograd Functions. The large matrix
products stay with ``torch.matmul``, as the JAX package left them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as _tF

from ...ops.kernels import flash_attention as _fa
from ...ops.kernels import layer_norm as _ln
from ...ops.kernels import softmax_ce as _sce

__all__ = ["linear", "embedding", "gelu", "dropout", "layer_norm",
           "scaled_dot_product_attention", "cross_entropy"]


def linear(x, weight, bias=None):
    """x @ weight + bias, with paddle's [in, out] weight layout."""
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def embedding(x, weight):
    """Rows of ``weight`` at the indices ``x``. The reference's ``take``
    fills an out-of-range index silently; here it raises (on a card, as a
    device-side assert), so callers pass valid ids."""
    return _tF.embedding(x, weight)


def gelu(x, approximate=False):
    """``approximate=True`` is the tanh form, as ``jax.nn.gelu``'s default."""
    return _tF.gelu(x, approximate="tanh" if approximate else "none")


def dropout(x, p=0.5, training=True, generator=None):
    """Upscale-in-train dropout: kept values are divided by 1 - p."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


def layer_norm(x, normalized_shape, weight, bias, epsilon=1e-5):
    """Layer norm over the last dim with an affine ``weight`` and ``bias``
    (the form every layer of the slice uses), by the layer-norm kernel."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    if list(normalized_shape) != [x.shape[-1]]:
        raise NotImplementedError(
            f"layer_norm over {list(normalized_shape)}: only the last dim "
            f"({x.shape[-1]}) is ported")
    return _ln.fused_layer_norm(x, weight, bias, epsilon)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """Batched attention in paddle's [B, L, H, D] layout. ``dropout_p``
    drops attention weights in training mode only."""
    p_eff = dropout_p if training else 0.0
    return _fa.flash_attention(query, key, value, mask=attn_mask,
                               causal=is_causal, dropout_p=p_eff,
                               generator=generator)


def _reduce_loss(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Cross-entropy over ``axis`` of ``input`` (logits, or probabilities
    with ``use_softmax=False``), in fp32.

    Hard labels: nll = logsumexp - logit[label]. The hard-label, softmax,
    unweighted, unsmoothed case over the last axis takes the fused
    softmax-CE Function (its kernel on a card); the rest are torch
    compositions, as in the reference. Any out-of-range label (not only
    ``ignore_index``) contributes zero loss and zero gradient, and
    ``reduction="mean"`` divides by the number of in-range labels (or by
    their summed class weights). Soft labels: -sum(soft * log_softmax),
    weighted by the class of each row's largest soft label."""
    logits = input
    ax = axis if axis >= 0 else logits.dim() + axis
    n_cls = logits.shape[ax]
    if soft_label:
        logp = (torch.log_softmax(logits, dim=ax) if use_softmax
                else torch.log(logits.clamp_min(1e-30)))
        soft = label
        if label_smoothing > 0.0:
            soft = soft * (1.0 - label_smoothing) + label_smoothing / n_cls
        nll = -(soft * logp).sum(dim=ax)
        if weight is not None:
            nll = nll * weight[soft.argmax(dim=ax)]
        return _reduce_loss(nll, reduction)
    li = label.long()
    if li.dim() == logits.dim() and li.shape[ax] == 1:
        li = li.squeeze(ax)
    safe = li.clamp(0, n_cls - 1)  # out-of-range labels are masked below
    if (use_softmax and weight is None and label_smoothing == 0.0
            and ax == logits.dim() - 1 and li.shape == logits.shape[:-1]):
        nll = _sce.fused_softmax_ce(logits, li)
    else:
        picked = logits.gather(ax, safe.unsqueeze(ax)).squeeze(ax).float()
        if use_softmax:
            lse = torch.logsumexp(logits.float(), dim=ax)
            nll = lse - picked
            if label_smoothing > 0.0:
                # smoothed CE adds eps * the mean over classes of -logp
                mean_logit = logits.float().mean(dim=ax)
                nll = ((1.0 - label_smoothing) * nll
                       + label_smoothing * (lse - mean_logit))
        else:
            nll = -torch.log(picked.clamp_min(1e-30))
            if label_smoothing > 0.0:
                mean_logp = torch.log(
                    logits.float().clamp_min(1e-30)).mean(dim=ax)
                nll = ((1.0 - label_smoothing) * nll
                       - label_smoothing * mean_logp)
    li = li.reshape(nll.shape)
    ww = None
    if weight is not None:
        ww = weight[safe.reshape(nll.shape)]
        nll = nll * ww
    mask = (li != ignore_index) & (li >= 0) & (li < n_cls)
    nll = torch.where(mask, nll, 0.0)
    if reduction == "mean":
        denom = (torch.where(mask, ww, 0.0).sum() if ww is not None
                 else mask.sum().clamp_min(1))
        return nll.sum() / denom
    return _reduce_loss(nll, reduction)
