"""The port's training slice (paddle_tpu_torch: F.cross_entropy, GPT.loss,
the optimizers, schedulers and clips, jit.TrainStep, utils.convert)
against the JAX package, on the CPU.

The same numpy inputs and weights go to both packages; the JAX side runs
its XLA paths (its Pallas kernels are off on the CPU), the port its plain
versions through the same autograd Functions a card uses. Tolerances:
- losses and gradients of the functionals, fp32 atol 1e-5 (sums in
  another order);
- the optimizers' updates, atol 1e-6 and rtol 1e-6: ULP level, since the
  port forms scalars such as 1 - beta ** t in Python floats where the
  reference forms them in float32 (the reference's own grouped update is
  not bit-identical on this jax either, so it is held to its sequential
  one); the port's grouped update must equal its own per-parameter loop
  exactly;
- TrainStep on GPTConfig.tiny() in fp32, losses and every parameter and
  slot after 3 AdamW steps, atol 1e-4 (but see ``_check`` for elements
  whose gradient is rounding noise); under O2 bf16, the first step's
  gradient of every parameter within 4e-2 of that parameter's largest
  gradient (each package rounds activations and cotangents to bf16 at
  other points: 1.9e-2 at worst on this model, against about 1e-2
  between either and the fp32 gradient), losses atol 2e-2 (bf16 rounding
  of activations and logits of a loss near 7) and parameters atol
  6 * lr: an Adam step moves an element by about lr, and a gradient near
  0 that rounds to the other sign in bf16 moves it the other way.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.jit import functionalize as jfunctionalize
from paddle_tpu.models.gpt import GPT as JGPT
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.nn import clip as jclip
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import jit, nn, optimizer
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.nn import clip
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.optimizer import lr
from paddle_tpu_torch.utils.convert import load_numpy_params, \
    load_train_state

OPT_TOL = dict(atol=1e-6, rtol=1e-6)


def _jt(x, dtype=np.float32, grad=False):
    return paddle.to_tensor(np.asarray(x, dtype), stop_gradient=not grad)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(getattr(x, "data", x), np.float32)


# ----------------------------- cross entropy ---------------------------------


def _ce_case(case):
    """(logits, labels, kwargs) for one F.cross_entropy case."""
    rng = np.random.default_rng(len(case))
    N, C = 12, 7
    x = rng.normal(scale=2.0, size=(N, C)).astype(np.float32)
    lab = rng.integers(0, C, N).astype(np.int64)
    lab[2], lab[7] = -100, C  # ignore_index and out of range
    kw = {}
    if case in ("mean", "sum", "none"):
        kw["reduction"] = case
    elif case == "weight":
        kw["weight"] = rng.uniform(0.5, 2.0, C).astype(np.float32)
    elif case == "smoothing":
        kw["label_smoothing"] = 0.1
    elif case == "soft":
        lab = rng.dirichlet(np.ones(C), N).astype(np.float32)
        kw["soft_label"] = True
        kw["weight"] = rng.uniform(0.5, 2.0, C).astype(np.float32)
    elif case == "no_softmax":
        x = rng.dirichlet(np.ones(C), N).astype(np.float32)
        kw["use_softmax"] = False
        kw["label_smoothing"] = 0.05
    elif case == "axis1":
        x = rng.normal(size=(3, C, 4)).astype(np.float32)
        lab = rng.integers(0, C, (3, 4)).astype(np.int64)
        lab[0, 0] = -100
        kw["axis"] = 1
    elif case == "label_dim1":
        lab = lab[:, None]
    return x, lab, kw


@pytest.mark.parametrize("case", ["mean", "sum", "none", "weight",
                                  "smoothing", "soft", "no_softmax", "axis1",
                                  "label_dim1"])
def test_cross_entropy_matches_reference(case):
    """Value and input gradient of the port's F.cross_entropy against the
    reference's, for every reduction, class weights, smoothing, soft
    labels, probabilities as input, another axis and [N, 1] labels."""
    x, lab, kw = _ce_case(case)
    soft = kw.get("soft_label", False)
    jkw = dict(kw)
    tkw = dict(kw)
    if "weight" in kw:
        jkw["weight"] = _jt(kw["weight"])
        tkw["weight"] = torch.from_numpy(kw["weight"])
    jx = _jt(x, grad=True)
    jlab = _jt(lab, np.float32 if soft else np.int32)
    jloss = JF.cross_entropy(jx, jlab, **jkw)
    jloss.sum().backward()
    tx = torch.from_numpy(x).requires_grad_(True)
    tloss = F.cross_entropy(tx, torch.from_numpy(lab), **tkw)
    tloss.sum().backward()
    assert tloss.dtype == torch.float32
    np.testing.assert_allclose(_np(tloss), _np(jloss), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(tx.grad), _np(jx.grad), atol=1e-5,
                               rtol=0)


# ------------------------------- optimizers ----------------------------------


OPTIMIZERS = {
    "SGD": ("SGD", dict(learning_rate=0.1, weight_decay=0.01)),
    "Momentum": ("Momentum", dict(learning_rate=0.1, momentum=0.9)),
    "Nesterov": ("Momentum", dict(learning_rate=0.1, momentum=0.9,
                                  use_nesterov=True, weight_decay=0.01)),
    "Adam": ("Adam", dict(learning_rate=0.01, weight_decay=0.01)),
    "AdamW": ("AdamW", dict(learning_rate=0.01, weight_decay=0.1)),
    "AdamW_exclude": ("AdamW", dict(
        learning_rate=0.01, weight_decay=0.1,
        apply_decay_param_fun=lambda n: "bias" not in n)),
    "AdamW_clip": ("AdamW", dict(learning_rate=0.01, weight_decay=0.1,
                                 grad_clip="global")),
}

SHAPES = {"a.weight": (4, 3), "a.bias": (3,), "b.weight": (5,),
          "c.scale": (2, 2)}


def _make_opts(key):
    name, kw = OPTIMIZERS[key]
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("grad_clip") == "global":
        jkw["grad_clip"] = jclip.ClipGradByGlobalNorm(0.5)
        tkw["grad_clip"] = clip.ClipGradByGlobalNorm(0.5)
    return (getattr(jopt, name)(parameters=[], **jkw),
            getattr(optimizer, name)(parameters=[], **tkw))


def _tree(rng, scale=1.0):
    return {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("key", list(OPTIMIZERS))
def test_apply_fn_matches_reference_sequential_update(key):
    """3 steps of the port's apply_fn against the reference's
    apply_fn(fused=False): parameters and every slot."""
    jo, to = _make_opts(key)
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jo.init_state_tree(jp), to.init_state_tree(tp)
    for t in (1, 2, 3):
        g = _tree(rng, 0.3)
        jp, js = jo.apply_fn(jp, {k: jnp.asarray(v) for k, v in g.items()},
                             js, t=t, fused=False)
        to.apply_fn(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts,
                    t=t, fused=False)
    for k in SHAPES:
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), **OPT_TOL)
        assert set(ts[k]) == set(js[k])
        for s in js[k]:
            np.testing.assert_allclose(_np(ts[k][s]), _np(js[k][s]),
                                       **OPT_TOL)


@pytest.mark.parametrize("key", ["SGD", "Nesterov", "AdamW_exclude"])
def test_grouped_update_equals_the_per_parameter_loop(key):
    _, fused = _make_opts(key)
    _, seq = _make_opts(key)
    assert fused.fused_update_supported
    rng = np.random.default_rng(1)
    p0 = _tree(rng)
    states = []
    for opt, is_fused in ((fused, True), (seq, False)):
        tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        ts = opt.init_state_tree(tp)
        grng = np.random.default_rng(2)
        for t in (1, 2, 3):
            g = {k: torch.from_numpy(v) for k, v in _tree(grng).items()}
            opt.apply_fn(tp, g, ts, t=t, fused=is_fused)
        states.append((tp, ts))
    (fp, fs), (sp, ss) = states
    for k in SHAPES:
        assert torch.equal(fp[k], sp[k])
        for s in fs[k]:
            assert torch.equal(fs[k][s], ss[k][s])


def test_eager_step_state_dict_and_clear_grad():
    rng = np.random.default_rng(3)
    ps = [torch.nn.Parameter(torch.from_numpy(v)) for v in _tree(rng).values()]
    opt = optimizer.AdamW(learning_rate=0.01, parameters=ps)
    for p in ps:
        p.grad = torch.ones_like(p)
    opt.step()
    sd = opt.state_dict()
    assert sd["step"] == 1 and set(sd) == {"step"} | {
        f"param_{i}.{s}" for i in range(4) for s in ("moment1", "moment2")}
    opt.clear_grad()
    assert all(p.grad is None for p in ps)
    other = optimizer.AdamW(learning_rate=0.01, parameters=ps)
    other.set_state_dict(sd)
    assert other._step_count == 1
    assert torch.equal(other._slots[id(ps[0])]["moment1"],
                       opt._slots[id(ps[0])]["moment1"])
    with pytest.raises(ValueError):
        optimizer.SGD()


def _schedulers(mod):
    return [
        mod.NoamDecay(64, 4, learning_rate=1.0),
        mod.PiecewiseDecay([3, 6], [0.1, 0.05, 0.01]),
        mod.NaturalExpDecay(0.1, 0.5),
        mod.InverseTimeDecay(0.1, 0.5),
        mod.PolynomialDecay(0.1, 5, cycle=True),
        mod.LinearWarmup(mod.CosineAnnealingDecay(0.1, 10), 3, 0.0, 0.1),
        mod.ExponentialDecay(0.1, 0.9),
        mod.MultiStepDecay(0.1, [2, 5]),
        mod.StepDecay(0.1, 3),
        mod.LambdaDecay(0.1, lambda e: 0.9 ** e),
        mod.CosineAnnealingDecay(0.1, 10),
        mod.CyclicLR(0.01, 0.1, 3, mode="triangular2"),
        mod.OneCycleLR(0.1, 10),
    ]


def test_lr_schedulers_match_reference():
    for js, ts in zip(_schedulers(jlr), _schedulers(lr)):
        for _ in range(12):
            assert ts() == js() and ts.get_lr() == js.get_lr(), type(ts)
            js.step()
            ts.step()
    jp, tp = jlr.ReduceOnPlateau(0.1, patience=1), lr.ReduceOnPlateau(
        0.1, patience=1)
    for m in (1.0, 0.9, 0.95, 0.97, 0.99, 0.5):
        jp.step(m)
        tp.step(m)
        assert tp() == jp()
    opt = optimizer.SGD(learning_rate=lr.StepDecay(0.1, 2), parameters=[])
    assert opt.get_lr() == 0.1
    with pytest.raises(RuntimeError):
        opt.set_lr(0.2)


def test_clips_match_reference():
    rng = np.random.default_rng(4)
    g = _tree(rng, 2.0)
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    for jc, tc in ((jclip.ClipGradByGlobalNorm(1.0),
                    clip.ClipGradByGlobalNorm(1.0)),
                   (jclip.ClipGradByValue(0.5), clip.ClipGradByValue(0.5))):
        want, got = jc.clip_fn(jg), tc.clip_fn(tg)
        for k in g:
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), **OPT_TOL)
    names = list(g)
    for jc, tc in ((jclip.ClipGradByGlobalNorm(1.0),
                    clip.ClipGradByGlobalNorm(1.0)),
                   (jclip.ClipGradByNorm(1.0), clip.ClipGradByNorm(1.0)),
                   (jclip.ClipGradByValue(0.5), clip.ClipGradByValue(0.5))):
        want = jc([(None, _jt(g[k])) for k in names])
        got = tc([(None, tg[k]) for k in names])
        for (_, w), (_, t) in zip(want, got):
            np.testing.assert_allclose(_np(t), _np(w), **OPT_TOL)


# ------------------------------ GPT training ---------------------------------


def _models():
    """The reference's tiny GPT (seed 0) and the port's, with its weights."""
    paddle.seed(0)
    jm = JGPT(JConfig.tiny())
    params = {k: np.asarray(p.data) for k, p in jm.named_parameters()}
    tm = GPT(GPTConfig.tiny(), device="cpu")
    load_numpy_params(tm, params)
    return jm, tm


def _batch(seed=0, B=2, L=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1024, (B, L)).astype(np.int32)
    labels = rng.integers(0, 1024, (B, L)).astype(np.int32)
    labels[0, :3] = -100
    return ids, labels


def _args(ids, labels):
    return ((_jt(ids, np.int32), _jt(labels, np.int32)),
            (torch.from_numpy(ids.astype(np.int64)),
             torch.from_numpy(labels.astype(np.int64))))


def _check(jparams, jslots, tparams, tslots, atol, flip):
    """Parameters and slots, {name: array} and {name: {slot: array}}.

    Elements whose gradient is rounding noise (the key bias of attention:
    softmax ignores a shift shared by a row's scores, so its exact gradient
    is 0) still move by about lr a step under Adam, in the direction of the
    noise's sign; those (second moment below 1e-12, |g| under ~1e-6) are
    held to ``flip`` = 2 * lr * steps, every other element to ``atol``."""
    for k, v in jparams.items():
        got, want = _np(tparams[k]), _np(v)
        live = np.sqrt(_np(jslots[k]["moment2"])) > 1e-6
        np.testing.assert_allclose(got[live], want[live], atol=atol, rtol=0,
                                   err_msg=k)
        np.testing.assert_allclose(got, want, atol=flip + atol, rtol=0,
                                   err_msg=k)
        for s, sv in jslots[k].items():
            np.testing.assert_allclose(_np(tslots[k][s]), _np(sv), atol=atol,
                                       rtol=0, err_msg=f"{k}.{s}")


def _check_state(jst, tst, atol, flip):
    _check(jst.params, jst.opt_state, tst.params, tst.opt_state, atol, flip)


def test_loss_and_every_gradient_match_reference():
    """GPT.loss and the gradient of every parameter, the reference's taken
    with jax.grad through its functionalized model."""
    jm, tm = _models()
    ids, labels = _batch()
    apply_fn, params, buffers = jfunctionalize(jm)

    def loss_of(p):
        logits, _ = apply_fn(p, buffers, None, jnp.asarray(ids))
        return JF.cross_entropy(JTensor(logits), JTensor(
            jnp.asarray(labels))).data

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_of))(params)
    (_, _), (ti, tl) = _args(ids, labels)
    tloss = tm.loss(ti, tl)
    tloss.backward()
    np.testing.assert_allclose(_np(tloss), np.asarray(jloss), atol=1e-5)
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(_np(p.grad), np.asarray(jgrads[k]),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_train_step_fp32_matches_reference():
    jm, tm = _models()
    jst = JTrainStep(jm, JF.cross_entropy, jopt.AdamW(
        learning_rate=1e-3, parameters=jm.parameters(), weight_decay=0.01),
        fused_opt=False)
    tst = jit.TrainStep(tm, F.cross_entropy, optimizer.AdamW(
        learning_rate=1e-3, parameters=tm.parameters(), weight_decay=0.01))
    assert tst.fused_opt
    for seed in range(3):
        (ja, ta) = _args(*_batch(seed))
        np.testing.assert_allclose(float(tst(*ta)), float(jst(*ja).data),
                                   atol=1e-4)
    _check_state(jst, tst, 1e-4, 2 * 1e-3 * 3)
    assert tst.state_dict()["t"] == 3
    for a, b in zip(tst.state_dict()["opt_flat"],
                    jst.state_dict()["opt_flat"]):
        assert a.shape == b.shape


def _check_o2_grads(tgrads, jslots, beta1=0.9):
    """The port's first-step O2 gradients ({name: fp32 grad}) against the
    reference's, read back from its moment1 = (1 - beta1) * g.

    Each parameter is cast to bf16 once, so its fp32 gradient is one bf16
    cotangent cast back, and every element is a bf16 value: the tied wte's
    two uses (embedding and logits) sum their cotangents in bf16 on its one
    copy, where two casts summed in fp32 would not round so. Each leaf is
    held to 4e-2 of its own largest reference gradient."""
    assert set(tgrads) == set(jslots)
    for k, g in tgrads.items():
        assert g.dtype == torch.float32
        assert torch.equal(g, g.bfloat16().float()), k
        want = _np(jslots[k]["moment1"]) / (1 - beta1)
        np.testing.assert_allclose(_np(g), want, rtol=0,
                                   atol=4e-2 * np.abs(want).max(),
                                   err_msg=k)


def test_train_step_o2_bf16_tracks_reference():
    jm, tm = _models()
    lr_ = 1e-3
    jst = JTrainStep(jm, JF.cross_entropy, jopt.AdamW(
        learning_rate=lr_, parameters=jm.parameters(), weight_decay=0.01),
        amp_dtype=jnp.bfloat16, fused_opt=False)
    tst = jit.TrainStep(tm, F.cross_entropy, optimizer.AdamW(
        learning_rate=lr_, parameters=tm.parameters(), weight_decay=0.01),
        amp_dtype=torch.bfloat16)
    grads = {}
    apply_fn = tst.optimizer.apply_fn

    def record(params, g, state, **kw):
        grads.update({k: v.clone() for k, v in g.items()})
        return apply_fn(params, g, state, **kw)

    tst.optimizer.apply_fn = record
    kernels.reset_stats()
    losses = []
    for seed in range(3):
        (ja, ta) = _args(*_batch(seed))
        tl = tst(*ta)
        assert tl.dtype == torch.float32
        losses.append(float(tl))
        np.testing.assert_allclose(losses[-1], float(jst(*ja).data),
                                   atol=2e-2)
        if seed == 0:
            _check_o2_grads(grads, jst.opt_state)
    assert losses[-1] < losses[0]
    # fp32 masters and slots; one pass through every plain version a step
    assert all(p.dtype == torch.float32 for p in tst.params.values())
    _check_state(jst, tst, 6 * lr_, 0.0)
    stats = kernels.all_stats()
    want = {"layer_norm": 5, "layer_norm_bwd": 5, "flash_attention": 2,
            "flash_attention_bwd": 2, "softmax_ce_fwd": 1,
            "softmax_ce_bwd": 1}
    for name, n in want.items():
        assert stats[name] == {"kernel": 0, "plain": 3 * n}, name


def test_eager_loop_matches_reference():
    """model.loss(...).backward(); opt.step(); opt.clear_grad() for 2
    steps in both packages: losses and parameters."""
    jm, tm = _models()
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                    weight_decay=0.01)
    to = optimizer.AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                         weight_decay=0.01)
    for seed in range(2):
        (ji, jl), (ti, tl) = _args(*_batch(seed))
        jloss = jm.loss(ji, jl)
        jloss.backward()
        jo.step()
        jo.clear_grad()
        tloss = tm.loss(ti, tl)
        tloss.backward()
        to.step()
        to.clear_grad()
        np.testing.assert_allclose(_np(tloss), _np(jloss), atol=1e-4)
    jparams = dict(jm.named_parameters())
    tparams = dict(tm.named_parameters())
    assert all(p.grad is None for p in tparams.values())
    _check(jparams, {k: jo._slots[id(p)] for k, p in jparams.items()},
           tparams, {k: to._slots[id(p)] for k, p in tparams.items()},
           1e-5, 2 * 1e-3 * 2)
    assert set(to.state_dict()) == set(jo.state_dict())


def test_resume_from_a_reference_state_dict():
    """Two reference steps, then both packages resume from that state (the
    port through utils.convert.load_train_state) and take a third."""
    jm, tm = _models()
    jst = JTrainStep(jm, JF.cross_entropy, jopt.AdamW(
        learning_rate=1e-3, parameters=jm.parameters(), weight_decay=0.01),
        fused_opt=False)
    for seed in range(2):
        jst(*_args(*_batch(seed))[0])
    sd = jst.state_dict()
    params = {k: np.asarray(v) for k, v in jst.params.items()}
    tst = jit.TrainStep(tm, F.cross_entropy, optimizer.AdamW(
        learning_rate=1e-3, parameters=tm.parameters(), weight_decay=0.01))
    load_train_state(tst, sd, params)
    assert tst._t == 2
    for a, b in zip(tst.state_dict()["opt_flat"], sd["opt_flat"]):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(_np(tm.wte.weight), params["wte.weight"])
    (ja, ta) = _args(*_batch(2))
    np.testing.assert_allclose(float(tst(*ta)), float(jst(*ja).data),
                               atol=1e-4)
    _check_state(jst, tst, 1e-4, 2 * 1e-3 * 3)
    with pytest.raises(ValueError):
        tst.set_state_dict({"t": 0, "opt_flat": sd["opt_flat"][:-1]})


def test_train_step_options():
    tm = GPT(GPTConfig.tiny(), device="cpu")
    opt = optimizer.AdamW(parameters=tm.parameters())
    hs = jit.TrainStep(tm, F.cross_entropy, opt, health=True)
    assert hs._health_probe is not None and hs.last_health is None
    assert not jit.TrainStep(tm, F.cross_entropy, opt,
                             fused_opt=False).fused_opt
    st = jit.TrainStep(tm, F.cross_entropy, opt)
    ids = torch.randint(1, 1024, (1, 8))
    before = tm.wte.weight.detach().clone()
    st(ids, ids)
    assert torch.equal(tm.wte.weight, before)   # masters are private
    st.sync_to_layer()
    assert torch.equal(tm.wte.weight, st.params["wte.weight"])


def test_parameter_names_are_stamped_once_at_construction():
    """A model names its parameters when it is built; listing a sub-layer
    first changes no name, so an optimizer over a sub-layer's parameters
    keys its state and its decay exclusion by the model's full names."""
    tm = GPT(GPTConfig.tiny(), device="cpu")
    blk = tm.blocks[1]
    assert [n for n, _ in blk.named_parameters()][0] == "ln1.weight"
    assert all(p.param_name == n for n, p in tm.named_parameters())
    opt = optimizer.AdamW(parameters=blk.parameters(),
                          apply_decay_param_fun=lambda n: "ln" not in n)
    for p in blk.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    assert set(opt.state_dict()) == {"step"} | {
        f"blocks.1.{n}.{s}" for n, _ in blk.named_parameters()
        for s in ("moment1", "moment2")}
    lone = nn.Linear(2, 2, device="cpu")
    list(lone.named_parameters())
    assert not hasattr(lone.weight, "param_name")


def test_decode_helpers_build_no_graph():
    """generate_*, forward_prefill and forward_decode run without autograd:
    no logits and no cache page require a gradient afterwards, so no graph
    grows through the cache as tokens are decoded."""
    tm = GPT(GPTConfig.tiny(), device="cpu")
    ids = torch.randint(1, 1024, (2, 8))
    out = tm.generate_paged(ids, 3)
    assert not out.requires_grad
    assert not tm.generate_dense(ids, 2).requires_grad
    cache = tm.init_cache(1, 32, page_size=8)
    cache.block_tables.copy_(torch.arange(1, 5, dtype=torch.int32)[None])
    logits, _ = tm.forward_prefill(ids[:1], cache, 0, 8)
    logits2, _ = tm.forward_decode(logits.argmax(-1), cache)
    assert not logits.requires_grad and not logits2.requires_grad
    assert logits.grad_fn is None
    assert not any(t.requires_grad for t in cache.k_pages + cache.v_pages)
