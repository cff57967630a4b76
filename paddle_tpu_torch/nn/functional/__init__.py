"""The functionals of the ported slices (counterpart of
``paddle_tpu/nn/functional/__init__.py``): ``linear`` (l.228),
``embedding`` (l.244), ``gelu`` (l.80), ``relu``, ``tanh`` (l.74),
``softmax`` (l.188), ``log_softmax`` (l.198), ``dropout`` (l.270),
``layer_norm`` (l.534), ``scaled_dot_product_attention`` (l.1285),
``cross_entropy`` (l.897), ``binary_cross_entropy_with_logits``
(l.1051), ``conv2d`` (l.377), ``max_pool2d`` (l.456),
``adaptive_avg_pool2d`` (l.491), ``flatten`` (``ops/manipulation.py:75``),
``batch_norm`` (l.709) and ``conv2d_bn`` (l.765).

Layer norm, attention, the hard-label softmax cross-entropy, the fused
BN(+add)+ReLU and the fused 1x1 conv + BN statistics go to the
hand-written kernels of ``ops/kernels`` (on a CUDA tensor) or their plain
versions (on a CPU tensor), through autograd Functions. The large matrix
products stay with ``torch.matmul`` and the other convolutions with
``torch.nn.functional.conv2d`` (cuDNN on a card), as the JAX package left
them to XLA. An fp32 convolution runs, forward and backward, with cuDNN's
TF32 switched off inside the call (``torch.backends.cudnn.allow_tf32`` is
True by default, which would take one TF32 pass where the reference
computes in fp32); the flag is restored after, and bf16 and fp16 calls
leave it alone.

Under ``amp.auto_cast`` the entries that the reference's AMP lists name
cast their inputs as its dispatch does (``ops/_dispatch.py``): ``linear``
and ``conv2d`` to the amp type; ``layer_norm``, ``cross_entropy`` and
``log_softmax`` to float32. The others follow their inputs.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as _tF

from ...framework import random as _random
from ...framework.dtype import convert_dtype
from ...ops import _bn_common as _bnc
from ...ops._bn_common import _bn_axes
from ...ops._dispatch import maybe_autocast
from ...ops.kernels import flash_attention as _fa
from ...ops.kernels import fused_bn as _fbn
from ...ops.kernels import fused_conv_bn as _fcb
from ...ops.kernels import layer_norm as _ln
from ...ops.kernels import softmax_ce as _sce

__all__ = ["linear", "embedding", "gelu", "relu", "tanh", "softmax",
           "log_softmax", "dropout", "layer_norm",
           "scaled_dot_product_attention", "cross_entropy", "conv2d",
           "max_pool2d", "adaptive_avg_pool2d", "flatten", "batch_norm",
           "conv2d_bn", "binary_cross_entropy_with_logits"]


def linear(x, weight, bias=None):
    """x @ weight + bias, with paddle's [in, out] weight layout."""
    x, weight, bias = maybe_autocast("linear", x, weight, bias)
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


def relu(x):
    return torch.relu(x)


def tanh(x):
    return torch.tanh(x)


def softmax(x, axis=-1, dtype=None):
    """Softmax over ``axis`` in x's type, then cast to ``dtype`` if given
    (as the reference casts its result)."""
    out = torch.softmax(x, dim=axis)
    return out if dtype is None else out.to(convert_dtype(dtype))


def log_softmax(x, axis=-1, dtype=None):
    """Log-softmax over ``axis`` (float32 under autocast), then cast to
    ``dtype`` if given."""
    (x,) = maybe_autocast("log_softmax", x)
    out = torch.log_softmax(x, dim=axis)
    return out if dtype is None else out.to(convert_dtype(dtype))


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, *, generator=None):
    """Dropout with the reference's signature (l.270). ``axis`` (an int or
    a list of dims) draws the keep mask over those dims only and
    broadcasts it over the rest. ``mode="upscale_in_train"`` divides kept
    values by 1 - p in training and is the identity in eval;
    ``"downscale_in_infer"`` keeps values unscaled in training and
    multiplies by 1 - p in eval. Any other mode raises."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout: mode {mode!r}; one of "
                         f"'upscale_in_train', 'downscale_in_infer'")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = _random.rand(shape, generator, x.device) >= p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def layer_norm(x, normalized_shape, weight, bias, epsilon=1e-5):
    """Layer norm over the last dim with an affine ``weight`` and ``bias``
    (the form every layer of the slice uses), by the layer-norm kernel."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    if list(normalized_shape) != [x.shape[-1]]:
        raise NotImplementedError(
            f"layer_norm over {list(normalized_shape)}: only the last dim "
            f"({x.shape[-1]}) is ported")
    x, weight, bias = maybe_autocast("layer_norm", x, weight, bias)
    return _ln.fused_layer_norm(x, weight, bias, epsilon)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, *,
                                 generator=None):
    """Batched attention in paddle's [B, L, H, D] layout, with the
    reference's slots (l.1285; ``name`` is taken and not used).
    ``dropout_p`` drops attention weights in training mode only;
    ``generator`` (keyword only) is the one the drop draws from."""
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


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """Sigmoid cross-entropy on logits in the reference's stable form
    (l.1051): with m = max(-z, 0),
    loss = (1 - y) z + m + log(exp(-m) + exp(-z - m)), and with
    ``pos_weight`` the log term scaled by (pos_weight - 1) y + 1;
    ``weight`` multiplies the elementwise loss before the reduction."""
    z, y = logit, label
    max_val = torch.clamp(-z, min=0)
    log_term = torch.log(torch.exp(-max_val) + torch.exp(-z - max_val))
    if pos_weight is not None:
        log_w = (pos_weight - 1) * y + 1
        loss = (1 - y) * z + log_w * (log_term + max_val)
    else:
        loss = (1 - y) * z + max_val + log_term
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


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
    weighted by the class of each row's largest soft label.

    Under data parallelism (a ``DataParallel`` forward, a grouped
    ``TrainStep``) the mean and the sum are those of the global batch:
    the count is all-reduced over the group (``parallel.group_loss``)."""
    logits, label, weight = maybe_autocast("cross_entropy", input, label,
                                           weight)
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
        scope = _dp_scope(reduction)
        if scope is not None:
            count = (torch.tensor(nll.numel(), device=nll.device)
                     if reduction == "mean" else None)
            return _dp_loss(nll.sum(), count, scope)
        return _reduce_loss(nll, reduction)
    li = label.long()
    if li.dim() == logits.dim() and li.shape[ax] == 1:
        li = li.squeeze(ax)
    if (use_softmax and weight is None and label_smoothing == 0.0
            and ax == logits.dim() - 1 and li.shape == logits.shape[:-1]):
        nll = _sce.fused_softmax_ce(logits, li)
    else:
        # out-of-range labels are masked below; a class weight comes
        # only here, so only this branch reads the clamped labels
        safe = li.clamp(0, n_cls - 1)
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
    scope = _dp_scope(reduction)
    if reduction == "mean":
        count = (torch.where(mask, ww, 0.0).sum() if ww is not None
                 else mask.sum())
        if scope is not None:
            return _dp_loss(nll.sum(), count, scope, clamp=ww is None)
        return nll.sum() / (count if ww is not None else count.clamp_min(1))
    if scope is not None:
        return _dp_loss(nll.sum(), None, scope)
    return _reduce_loss(nll, reduction)


def _dp_scope(reduction):
    """The data-parallel loss scope in force for a "mean"/"sum" loss."""
    if reduction not in ("mean", "sum"):
        return None
    from ...distributed import parallel
    return parallel.loss_group()


def _dp_loss(local_sum, count, scope, clamp=False):
    from ...distributed import parallel
    return parallel.group_loss(local_sum, count, scope, clamp=clamp)


# ------------------------------ convolution ---------------------------------


def _pair(v, n=2):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


def _conv_pads(padding, in_sizes, ksize, stride, dilation):
    """[(lo, hi)] per spatial dim for the reference's padding forms: an int
    or pair, "SAME"/"VALID", or 2 * nd ints (lo, hi per dim)."""
    nd = len(in_sizes)
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * nd
        if padding.upper() != "SAME":
            raise ValueError(f"conv2d: padding {padding!r}")
        pads = []  # XLA's SAME: the output is ceil(in / stride)
        for n, k, s, d in zip(in_sizes, ksize, stride, dilation):
            out = -(-n // s)
            total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    if isinstance(padding, (list, tuple)) and len(padding) == 2 * nd:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(nd)]
    return [(int(q), int(q)) for q in _pair(padding, nd)]


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """2-D convolution with the (O, I / groups, kh, kw) weight, in either
    layout. NHWC runs as a channels-last view of the same memory
    (``x.permute(0, 3, 1, 2)`` with a channels-last weight), so nothing is
    transposed and the output comes back as an NHWC view."""
    x, weight, bias = maybe_autocast("conv2d", x, weight, bias)
    stride, dilation = _pair(stride), _pair(dilation)
    nhwc = not data_format.startswith("NC")
    xin = x.permute(0, 3, 1, 2) if nhwc else x
    pads = _conv_pads(padding, tuple(xin.shape[2:]), tuple(weight.shape[2:]),
                      stride, dilation)
    w = weight.to(x.dtype)
    if nhwc:
        w = w.contiguous(memory_format=torch.channels_last)
    if all(lo == hi for lo, hi in pads):
        pad_arg = tuple(lo for lo, _ in pads)
    else:  # asymmetric: pad explicitly, then convolve unpadded
        xin = _tF.pad(xin, [q for lo, hi in reversed(pads) for q in (lo, hi)])
        pad_arg = 0
    b = None if bias is None else bias.to(x.dtype)
    if x.dtype == torch.float32:
        out = _Conv2dFP32.apply(xin, w, b, stride, pad_arg, dilation, groups)
    else:
        out = _tF.conv2d(xin, w, b, stride, pad_arg, dilation, groups)
    return out.permute(0, 2, 3, 1) if nhwc else out


@contextlib.contextmanager
def _cudnn_fp32():
    """cuDNN's fp32 convolutions in full fp32 inside (no TF32), every other
    cuDNN flag as it is; the caller's TF32 flag comes back after.
    (``torch.backends.cudnn.flags`` would also reset the flags it is not
    given to its own defaults.)"""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _Conv2dFP32(torch.autograd.Function):
    """An fp32 conv2d whose forward and backward both run with cuDNN's TF32
    off: the backward's flag is read when the backward runs, so it is set
    there too. On the CPU it computes what autograd's own conv backward
    does."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation, groups):
        with _cudnn_fp32():
            out = _tF.conv2d(x, w, b, stride, padding, dilation, groups)
        ctx.save_for_backward(x, w)
        nd = x.dim() - 2
        ctx.conf = (None if b is None else list(b.shape), list(stride),
                    [padding] * nd if isinstance(padding, int)
                    else list(padding), list(dilation), groups)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w = ctx.saved_tensors
        bias_sizes, stride, padding, dilation, groups = ctx.conf
        need = ctx.needs_input_grad
        mask = [need[0], need[1], bias_sizes is not None and need[2]]
        with _cudnn_fp32():
            dx, dw, db = torch.ops.aten.convolution_backward(
                dout, x, w, bias_sizes, stride, padding, dilation, False,
                [0] * len(stride), groups, mask)
        return (dx if mask[0] else None, dw if mask[1] else None,
                db if mask[2] else None, None, None, None, None)


# -------------------------------- pooling -----------------------------------


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW"):
    """Max pooling with -inf padding (the reference's reduce_window)."""
    if ceil_mode or return_mask:
        raise NotImplementedError(
            "max_pool2d: ceil_mode and return_mask are not ported")
    nhwc = data_format == "NHWC"
    xin = x.permute(0, 3, 1, 2) if nhwc else x
    out = _tF.max_pool2d(xin, _pair(kernel_size),
                         _pair(stride if stride is not None else kernel_size),
                         _pair(padding))
    return out.permute(0, 2, 3, 1) if nhwc else out


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """Mean over equal windows; the sizes must divide (the reference's
    other case is a linear resize, not a pooling, and is not ported)."""
    oh, ow = _pair(output_size)
    nchw = data_format == "NCHW"
    H, W = (x.shape[2], x.shape[3]) if nchw else (x.shape[1], x.shape[2])
    if H % oh or W % ow:
        raise NotImplementedError(
            f"adaptive_avg_pool2d: {H}x{W} to {oh}x{ow}; only sizes that "
            f"divide are ported")
    if nchw:
        r = x.reshape(x.shape[0], x.shape[1], oh, H // oh, ow, W // ow)
        return r.mean(dim=(3, 5))
    r = x.reshape(x.shape[0], oh, H // oh, ow, W // ow, x.shape[3])
    return r.mean(dim=(2, 4))


def flatten(x, start_axis=0, stop_axis=-1):
    return torch.flatten(x, start_axis, stop_axis)


# ----------------------------- batch norm ------------------------------------


class _BNTrainFunction(torch.autograd.Function):
    """Unfused training BN (the reference's ``_bn_train_core`` custom vjp,
    l.593-667): out = (x - mean) * inv * w + b in fp32, written in x's
    type; the backward is the classic fused formula
    dx = inv * (g - mean(g) - xhat * mean(g * xhat)). Returns (out, mean,
    var); the statistics carry no gradient. With a data-parallel
    ``group`` the statistics and the backward's two column sums are the
    group's (the gradients of w and b stay this rank's sums)."""

    @staticmethod
    def forward(ctx, x, w, b, epsilon, data_format, group=None):
        axes, shape = _bn_axes(x, data_format)
        mean, var, ctx.sync = _bnc.group_stats(x, axes, group)
        inv = torch.rsqrt(var + epsilon)
        out = (x.float() - mean.reshape(shape)) * inv.reshape(shape)
        if w is not None:
            out = out * w.reshape(shape).float()
        if b is not None:
            out = out + b.reshape(shape).float()
        ctx.save_for_backward(x, w, mean, inv)
        ctx.data_format, ctx.has_b = data_format, b is not None
        ctx.b_dtype = None if b is None else b.dtype
        ctx.mark_non_differentiable(mean, var)
        return out.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, w, mean, inv = ctx.saved_tensors
        axes, shape = _bn_axes(x, ctx.data_format)
        n = _bnc._rows(x, axes)
        dyf = dy.float()
        xhat = (x.float() - mean.reshape(shape)) * inv.reshape(shape)
        dbeta = dyf.sum(dim=axes)
        g = dyf if w is None else dyf * w.reshape(shape).float()
        gs, gxs = _bnc.group_sums(ctx.sync, g.sum(dim=axes),
                                  (g * xhat).sum(dim=axes))
        gm = gs / n
        gxm = gxs / n
        dx = inv.reshape(shape) * (g - gm.reshape(shape)
                                   - xhat * gxm.reshape(shape))
        dw = None if w is None else (dyf * xhat).sum(dim=axes).to(w.dtype)
        db = dbeta.to(ctx.b_dtype) if ctx.has_b else None
        return dx.to(x.dtype), dw, db, None, None, None


def _bn_infer(x, rm, rv, w, b, epsilon, data_format):
    """Inference BN with the running statistics (reference l.580)."""
    _, shape = _bn_axes(x, data_format)
    inv = torch.rsqrt(rv.reshape(shape) + epsilon)
    out = (x - rm.reshape(shape)) * inv
    if w is not None:
        out = out * w.reshape(shape)
    if b is not None:
        out = out + b.reshape(shape)
    return out.to(x.dtype)


def _bn_infer_act(x, rm, rv, w, b, residual, epsilon, data_format, act):
    """Inference BN with the fused train path's add/act epilogue
    (reference l.680), so a fused layer behaves alike in eval mode."""
    out = _bn_infer(x, rm, rv, w, b, epsilon, data_format)
    if residual is not None:
        out = out + residual
    if act == "relu":
        out = torch.relu(out)
    return out.to(x.dtype)


@torch.no_grad()
def _update_running_stats(running_mean, running_var, mean, var, momentum):
    """paddle's momentum update of the running statistics, in place:
    running = running * m + batch * (1 - m), with the biased batch
    variance (reference l.682). ``torch.nn.functional.batch_norm`` is not
    used: its momentum means 1 - m and it stores the unbiased variance."""
    if running_mean is None:
        return
    m = momentum
    running_mean.copy_(running_mean * m + mean * (1 - m))
    running_var.copy_(running_var * m + var * (1 - m))


def _bn_affine(x, weight, bias, data_format):
    """The fused kernels need gamma and beta: a disabled affine stands in
    as ones and zeros."""
    C = x.shape[1 if data_format.startswith("NC") else x.dim() - 1]
    w = torch.ones(C, device=x.device) if weight is None else weight
    b = torch.zeros(C, device=x.device) if bias is None else bias
    return w, b


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None, name=None, act=None, residual=None):
    """Batch norm with the reference's slots (l.709; ``name`` is taken and
    not used); in training mode the running statistics are updated in
    place. ``act``/``residual`` select the fused BN(+add)+ReLU
    (``ops/kernels/fused_bn``): out = act(BN(x) [+ residual]). Under a
    data-parallel group (``ops._bn_common.bn_scope``) the batch
    statistics, and so the running statistics, are the group's; with
    ``use_global_stats`` (eval mode's default) nothing is synchronized."""
    if use_global_stats is None:
        use_global_stats = not training
    if act is None and residual is None:
        if use_global_stats:
            return _bn_infer(x, running_mean, running_var, weight, bias,
                             epsilon, data_format)
        out, mean, var = _BNTrainFunction.apply(x, weight, bias, epsilon,
                                                data_format, _bnc.bn_group())
    else:
        if use_global_stats:
            return _bn_infer_act(x, running_mean, running_var, weight, bias,
                                 residual, epsilon, data_format, act)
        w, b = _bn_affine(x, weight, bias, data_format)
        if residual is not None:
            out, mean, var = _fbn.fused_bn_add_relu(
                x, residual, w, b, epsilon=epsilon, data_format=data_format,
                act=act)
        else:
            out, mean, var = _fbn.fused_bn_relu(
                x, w, b, epsilon=epsilon, data_format=data_format, act=act)
    _update_running_stats(running_mean, running_var, mean, var, momentum)
    return out


def conv2d_bn(x, conv_weight, running_mean, running_var, weight=None,
              bias=None, training=False, momentum=0.9, epsilon=1e-5,
              stride=1, padding=0, dilation=1, groups=1,
              data_format="NCHW", use_global_stats=None, act=None,
              residual=None, name=None):
    """conv2d + batch_norm(+residual add)(+act), in the reference's slots
    (l.765; ``name`` is taken and not used). A channels-last 1x1,
    stride-1 conv in training mode takes the fused chain
    (``ops/kernels/fused_conv_bn``: the product and the BN statistics in
    one pass, then the fused-BN apply); every other case is ``conv2d``
    then ``batch_norm(act=, residual=)``. The running statistics move as
    in ``batch_norm`` (the group's under a data-parallel group)."""
    if use_global_stats is None:
        use_global_stats = not training
    if not use_global_stats and _fcb.eligible(
            tuple(x.shape), tuple(conv_weight.shape), stride, padding,
            dilation, groups, data_format, x.dtype):
        Cout = conv_weight.shape[0]  # BN is sized by the conv's output
        w = torch.ones(Cout, device=x.device) if weight is None else weight
        b = torch.zeros(Cout, device=x.device) if bias is None else bias
        out, mean, var = _fcb.fused_conv1x1_bn_act(
            x, conv_weight, w, b, residual=residual, epsilon=epsilon,
            act=act)
        _update_running_stats(running_mean, running_var, mean, var,
                              momentum)
        return out
    y = conv2d(x, conv_weight, None, stride, padding, dilation, groups,
               data_format)
    return batch_norm(y, running_mean, running_var, weight, bias,
                      training=training, momentum=momentum, epsilon=epsilon,
                      data_format=data_format,
                      use_global_stats=use_global_stats, act=act,
                      residual=residual)
