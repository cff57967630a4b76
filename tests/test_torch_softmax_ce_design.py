"""The softmax CE's two designs and the cross-entropy entry around them.

``csrc/softmax_ce.cu`` runs a row of at most ``FWD_HOLD_MAX`` classes
(forward) or ``BWD_HOLD_MAX`` (backward) held in registers
("ce-warp-rows") and longer rows streamed by a block ("ce-stream");
``fwd_design`` / ``bwd_design`` are the Python twins of the launchers'
choice, and ``chip_smoke.py`` holds every launch on the card to them.
Here, without a card: the twins at every path's shape and at the edges of
the crossing, the twins' constants against the source's, the card
route's counting of the design a launch reports (``launch`` patched to
report one), and ``F.cross_entropy`` (the port's CPU path, through the
plain versions) against the reference's ``cross_entropy``, loss and
gradient, across V, reductions, ``ignore_index``, out-of-range labels,
class weights and smoothing.

Tolerances: losses and gradients in fp32 at rtol 1e-5 with atol 1e-7 (a
gradient element is about 1 / (N V) of the loss; both packages take the
log-sum-exp in fp32 in another order); bf16 logits at rtol 2^-8 (the
port's gradient is rounded to bf16 once, the reference's too) and atol
2^-9 of the largest gradient (the reference rounds the softmax to bf16
before it subtracts the one-hot, the port after).
"""
import pathlib
import re

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import softmax_ce as sce

SRC = (pathlib.Path(sce.__file__).resolve().parents[2] / "csrc"
       / "softmax_ce.cu")
f32, bf16 = torch.float32, torch.bfloat16


# --------------------------------- the twins ---------------------------------


@pytest.mark.parametrize("N,V,dtype,fwd,bwd", [
    # ResNet's head, fp32 under Model.fit and bf16 under O2: 1,000 classes
    # spread over a block in both directions
    (128, 1000, f32, "ce-stream", "ce-stream"),
    (128, 1000, bf16, "ce-stream", "ce-stream"),
    (256, 2, bf16, "ce-warp-rows", "ce-warp-rows"),       # BERT's 2-way head
    (64, 10, f32, "ce-warp-rows", "ce-warp-rows"),        # LeNet's head
    (8192, 50304, bf16, "ce-stream", "ce-stream"),        # GPT b8 under O2
    (8192, 50304, f32, "ce-stream", "ce-stream"),         # GPT b8, Model.fit
    (32768, 50304, bf16, "ce-stream", "ce-stream"),       # the long path
    (4096, 40000, bf16, "ce-stream", "ce-stream"),        # ERNIE's MLM head
    (3584, 37000, bf16, "ce-stream", "ce-stream"),        # Transformer-base
])
def test_twins_at_the_paths_shapes(N, V, dtype, fwd, bwd):
    """The twins read V alone: the same design at each path's N and
    type."""
    assert sce.fwd_design(V) == fwd
    assert sce.bwd_design(V) == bwd


@pytest.mark.parametrize("dtype", [f32, bf16])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_twins_at_the_crossing(dtype, direction):
    """Rows up to the direction's widest held row are held; one element or
    one 16-byte vector of the type wider streams."""
    twin = getattr(sce, f"{direction}_design")
    hold = getattr(sce, f"{direction.upper()}_HOLD_MAX")
    vec = 16 // dtype.itemsize
    for V in (1, 2, 31, 33, hold - vec, hold - 1, hold):
        assert twin(V) == "ce-warp-rows"
    for V in (hold + 1, hold + vec, 2 * hold, 50304):
        assert twin(V) == "ce-stream"


def test_twins_constants_are_the_sources():
    """FWD_HOLD_MAX and BWD_HOLD_MAX are the source's PT_CE_FWD_HOLD_MAX
    and PT_CE_BWD_HOLD_MAX, DESIGNS its Design codes in order."""
    src = SRC.read_text()
    for macro, value in (("PT_CE_FWD_HOLD_MAX", sce.FWD_HOLD_MAX),
                         ("PT_CE_BWD_HOLD_MAX", sce.BWD_HOLD_MAX)):
        found = re.search(rf"#define {macro} (\d+)", src)
        assert int(found.group(1)) == value, macro
    enum = re.search(r"enum Design \{([^}]*)\}", src).group(1)
    codes = [int(c) for c in re.findall(r"= (\d+)", enum)]
    assert codes == list(range(len(sce.DESIGNS)))
    assert "kWarpRows = 0" in enum and "kStream = 1" in enum


@pytest.mark.parametrize("code", [0, 1])
def test_card_route_counts_the_reported_design(monkeypatch, code):
    """On a card, each launch counts the design its C entry wrote into
    its out-parameter, under the launch's shape; nothing else is
    computed here (the patched launch writes the code and returns)."""
    calls = []

    def launch(name, entry, device, *args):
        calls.append(entry)
        args[-1]._obj.value = code

    monkeypatch.setattr(sce, "use_kernel", lambda t: True)
    monkeypatch.setattr(sce, "launch", launch)
    kernels.reset_stats()
    x = torch.zeros(6, 1000)
    lab = torch.zeros(6, dtype=torch.int32)
    _, lse = sce.softmax_ce_fwd(x, lab)
    sce.softmax_ce_bwd(x, lab, lse, torch.ones(6))
    assert calls == ["pt_softmax_ce_fwd", "pt_softmax_ce_bwd"]
    for name in ("softmax_ce_fwd", "softmax_ce_bwd"):
        assert kernels.design_stats()[name] == {sce.DESIGNS[code]: 1}
        assert kernels.shape_stats()[name] == {"N=6 V=1000 float32": 1}
    kernels.reset_stats()


# ------------------- F.cross_entropy against the reference -------------------


def _inputs(seed, N, V, dtype, labels):
    rng = np.random.default_rng(seed)
    x = (2 * rng.standard_normal((N, V))).astype(np.float32)
    if dtype == "bfloat16":  # both packages see the same bf16 values
        x = torch.from_numpy(x).to(bf16).float().numpy()
    lab = rng.integers(0, V, N)
    if labels == "ignore":
        lab[::3] = -100
    elif labels == "out_of_range":
        lab[::3] = -100
        lab[1::4] = V
        lab[2::5] = V + 7
        lab[3::7] = -2
    cot = rng.standard_normal(N).astype(np.float32)
    return x, lab, cot


def _reference(x, lab, cot, dtype, reduction, **kw):
    """The reference's loss and d(loss . cot)/dx (its eager tape)."""
    jx = paddle.to_tensor(x, stop_gradient=False)  # an fp32 leaf
    extra = {}
    if "weight" in kw:
        extra["weight"] = paddle.to_tensor(kw.pop("weight"))
    loss = JF.cross_entropy(jx.astype(dtype),
                            paddle.to_tensor(lab.astype(np.int32)),
                            reduction=reduction, **extra, **kw)
    out = loss * paddle.to_tensor(cot) if reduction == "none" else loss
    out.sum().backward()
    return (np.asarray(loss.numpy(), np.float32),
            np.asarray(jx.grad.numpy(), np.float32))


def _port(x, lab, cot, dtype, reduction, **kw):
    tx = torch.from_numpy(x).requires_grad_(True)  # an fp32 leaf
    if "weight" in kw:
        kw["weight"] = torch.from_numpy(kw["weight"])
    loss = F.cross_entropy(tx.to(getattr(torch, dtype)),
                           torch.from_numpy(lab), reduction=reduction, **kw)
    out = loss * torch.from_numpy(cot) if reduction == "none" else loss
    out.sum().backward()
    return loss.detach().float().numpy(), tx.grad.float().numpy()


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    else:
        # the reference rounds the softmax to bf16 before it subtracts the
        # one-hot (p = 0.99994 gives 0), the port after: half a bf16 ulp
        # of 1 at the largest element's scale apart
        np.testing.assert_allclose(got, want, rtol=2.0 ** -8,
                                   atol=2.0 ** -9 * np.abs(want).max())


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("labels", ["in_range", "ignore", "out_of_range"])
@pytest.mark.parametrize("V", [1, 2, 10, 1000, 1001])
def test_cross_entropy_matches_the_reference(V, labels, reduction):
    """The fused path (the Function over the plain versions on the CPU):
    loss and gradient. Out-of-range labels give 0 loss and 0 gradient in
    both; mean divides by the in-range labels."""
    x, lab, cot = _inputs(V, 24, V, "float32", labels)
    before = dict(sce._stats)
    got = _port(x, lab, cot, "float32", reduction)
    assert sce._stats["plain"] == before["plain"] + 1
    want = _reference(x, lab, cot, "float32", reduction)
    for g, w in zip(got, want):
        _close(g, w, "float32")
    bad = (lab < 0) | (lab >= V)
    assert not got[1][bad].any()


@pytest.mark.parametrize("V", [2, 1000])
def test_cross_entropy_bf16_matches_the_reference(V):
    x, lab, cot = _inputs(V + 1, 16, V, "bfloat16", "out_of_range")
    got = _port(x, lab, cot, "bfloat16", "mean")
    want = _reference(x, lab, cot, "bfloat16", "mean")
    for g, w in zip(got, want):
        _close(g, w, "bfloat16")


@pytest.mark.parametrize("case", ["weight", "smoothing", "probabilities"])
@pytest.mark.parametrize("V", [2, 1001])
def test_composed_cross_entropy_matches_the_reference(case, V):
    """The composed path, which alone reads the clamped labels: class
    weights (gathered at the clamped label), label smoothing and
    use_softmax=False, with out-of-range labels."""
    x, lab, cot = _inputs(2 * V, 24, V, "float32", "out_of_range")
    kw = {}
    if case == "weight":
        kw["weight"] = np.random.default_rng(V).uniform(
            0.5, 2.0, V).astype(np.float32)
    elif case == "smoothing":
        kw["label_smoothing"] = 0.1
    else:
        x = np.abs(x) / np.abs(x).sum(-1, keepdims=True)
        kw["use_softmax"] = False
    before = dict(sce._stats)
    got = _port(x, lab, cot, "float32", "mean", **dict(kw))
    assert sce._stats == before  # not the fused Function
    want = _reference(x, lab, cot, "float32", "mean", **dict(kw))
    for g, w in zip(got, want):
        _close(g, w, "float32")
