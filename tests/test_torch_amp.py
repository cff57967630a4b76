"""The port's AMP (paddle_tpu_torch.amp: auto_cast, amp_guard, decorate,
GradScaler, and the op lists of ops/_dispatch.py) against the JAX
package's, on the CPU.

O1 casts by op name at the ``nn.functional`` entries: products to the amp
type, losses and norms to float32, the rest following their inputs. The
same numpy inputs and weights go to both packages. Tolerances:
- the types each entry returns must equal the reference's exactly;
- the eager BERT classifier (tiny) under O1: bf16 loss atol 2e-2, fp16
  (10-bit significand, 8 times finer) atol 3e-3, fp32 without autocast
  1e-4; each gradient within twice the reference's own distance from
  the fp32 gradient plus 2e-2 (bf16), 3e-3 (fp16) or 1e-4 (fp32) of the
  leaf's largest fp32 gradient (see the test);
- GradScaler: the scale, its counters and the skipped steps must equal
  the reference's exactly, and the parameters after each step atol 1e-6.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework import flags as jflags
from paddle_tpu.models import bert as jbert
from paddle_tpu.models.gpt import GPT as JGPT
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import amp, nn, optimizer
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import _dispatch
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.utils.convert import load_numpy_params

TDT = {"bfloat16": torch.bfloat16, "float16": torch.float16,
       "float32": torch.float32}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(getattr(x, "data", x), np.float32)


def _jdt(x):
    return str(np.dtype(getattr(x, "data", x).dtype))


def _tdt(x):
    return str(x.dtype).replace("torch.", "")


def _pair(a, dtype="float32"):
    a = np.asarray(a, np.float32)
    return (paddle.to_tensor(a).astype(dtype),
            torch.from_numpy(a).to(TDT[dtype]))


# ------------------------- the lists at the entries --------------------------


def _entries(rng):
    """(name, reference call, port call) for each functional entry the
    lists name or the BERT path runs."""
    (jx, tx), (jw, tw), (jb, tb) = (_pair(rng.standard_normal(s))
                                    for s in ((4, 8), (8, 6), (6,)))
    (jg, tg), (jbe, tbe) = _pair(np.ones(8)), _pair(np.zeros(8))
    (jh, th) = _pair(rng.standard_normal((4, 8)), "bfloat16")
    lab = rng.integers(0, 8, 4)
    jl, tl = paddle.to_tensor(lab.astype(np.int32)), torch.from_numpy(lab)
    (jc, tc), (jk, tk) = (_pair(rng.standard_normal(s))
                          for s in ((1, 3, 6, 6), (4, 3, 3, 3)))
    return [
        ("linear", lambda: JF.linear(jx, jw, jb), lambda: F.linear(tx, tw, tb)),
        ("conv2d", lambda: JF.conv2d(jc, jk), lambda: F.conv2d(tc, tk)),
        ("layer_norm bf16", lambda: JF.layer_norm(jh, 8, jg, jbe),
         lambda: F.layer_norm(th, 8, tg, tbe)),
        ("cross_entropy bf16", lambda: JF.cross_entropy(jh, jl),
         lambda: F.cross_entropy(th, tl)),
        ("log_softmax bf16", lambda: JF.log_softmax(jh),
         lambda: F.log_softmax(th)),
        ("softmax bf16", lambda: JF.softmax(jh), lambda: F.softmax(th)),
        ("gelu bf16", lambda: JF.gelu(jh), lambda: F.gelu(th)),
        ("tanh fp32", lambda: JF.tanh(jx), lambda: F.tanh(tx)),
        ("embedding", lambda: JF.embedding(jl, jw),
         lambda: F.embedding(tl, tw)),
    ]


@pytest.mark.parametrize("lists", ["default", "custom"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_entries_return_the_reference_types(dtype, lists):
    """Each entry's output type under auto_cast equals the reference's:
    white ops in the amp type, black ops in float32, the rest following
    their inputs; custom lists (linear black, layer_norm and cross
    entropy white) move ops across, and the lists apply at O2 too."""
    kw = {}
    if lists == "custom":
        kw = dict(custom_white_list={"layer_norm", "cross_entropy"},
                  custom_black_list={"linear"}, level="O2")
    for name, jcall, tcall in _entries(np.random.default_rng(0)):
        with jamp.auto_cast(dtype=dtype, **kw):
            want = _jdt(jcall())
        with amp.auto_cast(dtype=dtype, **kw):
            got = _tdt(tcall())
        assert got == want, (name, got, want)
        assert _tdt(tcall()) == _jdt(jcall()), name  # outside: unchanged
    assert not _dispatch.amp_state()["enabled"]


def test_auto_cast_nests_restores_and_aliases():
    assert amp.amp_guard is amp.auto_cast
    x, w = torch.ones(2, 3), torch.ones(3, 3)
    with amp.auto_cast(dtype="float16"):
        with amp.amp_guard(enable=False):
            assert F.linear(x, w).dtype == torch.float32
        assert F.linear(x, w).dtype == torch.float16
        assert _dispatch.amp_state()["dtype"] == torch.float16
    st = _dispatch.amp_state()
    assert not st["enabled"] and st["dtype"] == torch.bfloat16
    assert st["custom_white"] == set() and st["level"] == "O1"


def test_decorate_o2_casts_parameters():
    """decorate(level="O2") casts every float32 parameter to the amp type
    in place, as the reference's does; O1 leaves them; with optimizers it
    returns both."""
    paddle.seed(0)
    jm = jnn.Linear(4, 3)
    tm = nn.Linear(4, 3, device="cpu")
    opt = optimizer.SGD(0.1, parameters=tm.parameters())
    assert amp.decorate(tm, level="O1") is tm
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    models, opts = amp.decorate([tm], opt, level="O2", dtype="float16")
    jamp.decorate(jm, level="O2", dtype="float16")
    assert models == [tm] and opts is opt
    assert [_tdt(p) for p in tm.parameters()] == \
        [_jdt(p) for p in jm.parameters()] == ["float16"] * 2
    assert opt._parameter_list[0] is tm.weight


# ------------------------- O1 on the BERT classifier -------------------------


class _JCls(jnn.Layer):
    def __init__(self, cfg):
        super().__init__()
        self.bert = jbert.Bert(cfg)
        self.head = jnn.Linear(cfg.hidden_size, 2)

    def forward(self, ids):
        return self.head(self.bert(ids)[1])


class _Cls(nn.Layer):
    def __init__(self, cfg):
        super().__init__("cpu")
        self.bert = bert.Bert(cfg, device="cpu")
        self.head = nn.Linear(cfg.hidden_size, 2, device="cpu")
        self.name_parameters()

    def forward(self, ids):
        return self.head(self.bert(ids)[1])


#: (loss atol, gradient tolerance of the leaf's largest fp32 gradient)
O1_TOL = {"bfloat16": (2e-2, 2e-2), "float16": (3e-3, 3e-3),
          "float32": (1e-4, 1e-4)}


def _o1_models(model):
    """The reference's tiny model (seed 0) and the port's with its
    weights, and a batch: the BERT classifier (2 classes) or GPT (its LM
    loss, the tied logits through the white-listed matmul)."""
    paddle.seed(0)
    if model == "bert":
        jm, tm = _JCls(jbert.BertConfig.tiny()), _Cls(bert.BertConfig.tiny())
        shape, n_cls = (4,), 2
    else:
        jm, tm = JGPT(JGPTConfig.tiny()), GPT(GPTConfig.tiny(), device="cpu")
        shape, n_cls = (4, 32), 1024
    load_numpy_params(tm, {k: np.asarray(p.data)
                           for k, p in jm.named_parameters()})
    rng = np.random.default_rng(1)
    return (jm, tm, rng.integers(0, 1000, (4, 32)),
            rng.integers(0, n_cls, shape))


@contextlib.contextmanager
def _reference_op_by_op():
    """The reference's eager op cache off: it runs each op by itself. With
    the cache on, an op seen twice is jit-compiled, and XLA's fusions keep
    some bf16 intermediates in fp32, so its bf16 numbers would depend on
    which ops earlier tests had already run."""
    prev = jflags.get_flags("FLAGS_eager_op_cache")["FLAGS_eager_op_cache"]
    jflags.set_flags({"FLAGS_eager_op_cache": False})
    try:
        yield
    finally:
        jflags.set_flags({"FLAGS_eager_op_cache": prev})


def _o1_run(dtype, model="bert"):
    """The eager loop's forward and backward of a tiny model in both
    packages under auto_cast(level="O1", dtype) (float32: no autocast):
    (reference loss, port loss, {name: (reference gradient, port
    gradient)}), and the port's kernel and composition counts."""
    jm, tm, ids, lab = _o1_models(model)
    on = dtype != "float32"
    kernels.reset_stats()
    with _reference_op_by_op(), jamp.auto_cast(enable=on, level="O1",
                                               dtype=dtype):
        jlogits = jm(paddle.to_tensor(ids.astype(np.int32)))
        jloss = JF.cross_entropy(jlogits,
                                 paddle.to_tensor(lab.astype(np.int32)))
    with amp.auto_cast(enable=on, level="O1", dtype=dtype):
        tlogits = tm(torch.from_numpy(ids))
        tloss = F.cross_entropy(tlogits, torch.from_numpy(lab))
    # the logits come from a white-listed product (linear, matmul)
    assert _tdt(tlogits) == _jdt(jlogits) == dtype
    assert tloss.dtype == torch.float32
    with _reference_op_by_op():
        jloss.backward()
    tloss.backward()
    jp = dict(jm.named_parameters())
    grads = {k: (_np(jp[k].grad), _np(p.grad))
             for k, p in tm.named_parameters()}
    return (float(_np(jloss)), float(_np(tloss)), grads,
            kernels.all_stats(), kernels.composed_stats())


@pytest.fixture(scope="module")
def fp32_runs():
    return {m: _o1_run("float32", m) for m in ("bert", "gpt")}


@pytest.mark.parametrize("model", ["bert", "gpt"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_o1_loss_and_gradients_match_reference(dtype, model, fp32_runs):
    """The loss and every parameter's gradient under O1 against the
    reference's. A low-precision gradient is held against the reference's
    by how far the reference's own lies from the fp32 gradient of the same
    weights: |port - ref| <= 2 |ref - fp32| + tol * s, s the leaf's largest
    fp32 gradient (the whole model's for the key bias, whose exact
    gradient is 0). The q and k projections' gradients pass through the
    softmax's derivative, a difference of nearly equal terms, and lie
    30-45 % (bf16) from fp32 in both packages at this size. Layer norm
    and the CE run in float32 (black list) in both."""
    fp32_run = fp32_runs[model]
    jloss, tloss, grads, stats, composed = (
        fp32_run if dtype == "float32" else _o1_run(dtype, model))
    truth = fp32_run[2]
    latol, rel = O1_TOL[dtype]
    np.testing.assert_allclose(tloss, jloss, atol=latol)
    top = max(np.abs(t[0]).max() for t in truth.values())
    for k, (jg, tg) in grads.items():
        t = truth[k][0]
        s = np.abs(t).max()
        if s < 1e-6 * top:
            s = top
        bound = 2 * np.abs(jg - t).max() + rel * s
        assert np.abs(tg - jg).max() <= bound, (k, np.abs(tg - jg).max(),
                                                 bound)
    # the CPU runs every attention's plain version (a card composes fp16:
    # tests/test_torch_dispatch.py); layer norm and the CE got float32
    assert stats["flash_attention"]["plain"] == 2
    assert stats["layer_norm"]["plain"] == 5
    assert stats["softmax_ce_fwd"]["plain"] == 1
    assert not composed["layer_norm"] and not composed["softmax_ce"]


# -------------------------------- GradScaler --------------------------------


def _scaler_kw():
    return dict(init_loss_scaling=1024.0, incr_ratio=2.0, decr_ratio=0.5,
                incr_every_n_steps=3, decr_every_n_nan_or_inf=2)


#: steps whose gradient gets an inf injected after backward
INF_STEPS = (1, 2, 6, 9, 10, 11)


def _scaler_run(pkg, steps=13, resume_at=None):
    """A fp32 Linear trained by SGD through GradScaler, with infs injected
    at INF_STEPS; returns per step (scale, state_dict, skipped) and the
    final weights. With ``resume_at``, the scaler is rebuilt from its
    state_dict before that step (a round trip)."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    xs = rng.standard_normal((steps, 5, 4)).astype(np.float32)
    if pkg == "ref":
        m = jnn.Linear(4, 3)
        m.weight.data = jnp.asarray(w0)
        opt = jopt.SGD(0.1, parameters=m.parameters())
        scaler = jamp.GradScaler(**_scaler_kw())
        new_scaler = lambda: jamp.GradScaler(**_scaler_kw())
    else:
        m = nn.Linear(4, 3, device="cpu")
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(w0))
        opt = optimizer.SGD(0.1, parameters=m.parameters())
        scaler = amp.GradScaler(**_scaler_kw())
        new_scaler = lambda: amp.GradScaler(**_scaler_kw())
    seq = []
    for i in range(steps):
        if i == resume_at:
            sd = scaler.state_dict()
            scaler = new_scaler()
            scaler.load_state_dict(sd)
        before = _np(m.weight).copy()
        x = paddle.to_tensor(xs[i]) if pkg == "ref" else torch.from_numpy(
            xs[i])
        loss = (m(x) ** 2).mean()
        scaler.scale(loss).backward()
        if i in INF_STEPS:
            g = np.array(_np(m.weight.grad))
            g[1, 2] = np.inf
            if pkg == "ref":
                m.weight.grad = paddle.to_tensor(g)
            else:
                m.weight.grad.copy_(torch.from_numpy(g))
        scaler.step(opt)
        opt.clear_grad()
        skipped = bool(np.array_equal(_np(m.weight), before))
        seq.append((float(_np(scaler.get_loss_scaling())),
                    scaler.state_dict(), skipped))
    return seq, _np(m.weight)


@pytest.mark.parametrize("resume_at", [None, 7])
def test_grad_scaler_sequence_matches_reference(resume_at):
    """Back-off after decr_every_n_nan_or_inf (2) consecutive non-finite
    steps, growth after incr_every_n_steps (3) finite ones, every
    non-finite step skipped, and a state_dict round trip midway."""
    want, wref = _scaler_run("ref")
    got, wport = _scaler_run("port", resume_at=resume_at)
    assert [s[2] for s in got] == [i in INF_STEPS for i in range(13)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0] and g[1] == w[1], i
    scales = [s[0] for s in got]
    assert scales[2] == 512.0 and scales[5] == 1024.0  # back off, grow
    np.testing.assert_allclose(wport, wref, atol=1e-6, rtol=0)


def test_grad_scaler_unscale_is_one_pass_and_disabled_passes_through():
    """unscale_ divides every gradient once (a second call in the same
    step does nothing) and finds an inf in any of them; a disabled
    scaler leaves the loss and steps the optimizer."""
    m = nn.Linear(3, 2, device="cpu")
    opt = optimizer.SGD(0.1, parameters=m.parameters())
    sc = amp.GradScaler(init_loss_scaling=8.0)
    sc.scale(m(torch.ones(1, 3)).sum()).backward()
    g = [p.grad.clone() for p in opt._parameter_list]
    sc.unscale_(opt)
    sc.unscale_(opt)
    for p, g0 in zip(opt._parameter_list, g):
        torch.testing.assert_close(p.grad, g0 / 8.0, rtol=0, atol=0)
    assert not sc._found_inf
    m.bias.grad[0] = float("nan")
    sc._unscaled = False
    sc.unscale_(opt)
    assert sc._found_inf
    off = amp.GradScaler(enable=False)
    loss = m(torch.ones(1, 3)).sum()
    assert off.scale(loss) is loss and not off.is_enable()
    assert off.get_loss_scaling().item() == 1.0
    opt.clear_grad()
    loss.backward()
    before = m.weight.detach().clone()
    off.step(opt)
    assert not torch.equal(m.weight, before)


@pytest.mark.parametrize("axis", [-1, 0])
def test_tanh_softmax_log_softmax_match_reference(axis):
    """The functionals this slice adds, fp32 atol 1e-6, and their
    ``dtype`` cast."""
    a = np.random.default_rng(4).standard_normal((5, 7)).astype(np.float32)
    ja, ta = paddle.to_tensor(a), torch.from_numpy(a)
    for jf, tf in ((lambda x: JF.tanh(x), lambda x: F.tanh(x)),
                   (lambda x: JF.softmax(x, axis), lambda x: F.softmax(x, axis)),
                   (lambda x: JF.log_softmax(x, axis),
                    lambda x: F.log_softmax(x, axis))):
        np.testing.assert_allclose(_np(tf(ta)), _np(jf(ja)), atol=1e-6,
                                   rtol=0)
    got = F.softmax(ta, axis, dtype="bfloat16")
    want = JF.softmax(ja, axis, dtype="bfloat16")
    assert _tdt(got) == _jdt(want) == "bfloat16"
