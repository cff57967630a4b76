"""The port's long-context slice (paddle_tpu_torch: the split flash
backward, distributed.fleet.utils.recompute, GPTConfig.remat and
ResNet(recompute=True)) against the JAX package, on the CPU.

The same numpy inputs and weights go to both packages. The split
backward's plain versions are held against the reference's
``_fa_bwd_pallas`` in the Pallas interpreter, as its own tests run it; the
models run the reference's XLA paths and the port's plain versions,
through the autograd Functions a card uses.

Tolerances:
- split backward, fp32: atol 1e-5 (gradients of order 1, sums in another
  order; as for the one-pass backward in test_torch_kernels.py); bf16
  inputs: 2e-2 of each gradient's largest magnitude, since the reference
  rounds P and dS to bf16 before its products (each a relative 2^-9) and
  rounds its outputs once more, where the plain version keeps fp32 to the
  end;
- GPTConfig.tiny() under TrainStep in fp32, port against reference with
  the same remat: the loss atol 1e-5 and every gradient atol 1e-5 (as for
  the no-remat step in test_torch_train.py); inside the port, every remat
  mode gives the no-remat loss and gradients bit for bit (the replay runs
  the same operations on the same tensors), in fp32, under O2 bf16, and
  with dropout replayed from the saved RNG state;
- resnet18 (NHWC) with recompute=True in fp32, port against reference:
  the bounds of the whole-model ResNet step in test_torch_resnet.py
  (loss 1e-3 of itself, gradient 10 % whole and 15 % a leaf in relative
  L2, running statistics 1e-3 of each buffer's scale); inside the port,
  recompute gives the no-recompute step bit for bit, running statistics
  included (they move once, in the forward).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models.gpt import GPT as JGPT
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch import jit, nn, optimizer
from paddle_tpu_torch.distributed.fleet.utils import recompute, \
    recompute_policies
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.utils.convert import load_numpy_params

BWD_ATOL = 1e-5
BF16_REL = 2e-2
LR = 1e-3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    if hasattr(x, "data") and not isinstance(x, np.ndarray):
        x = x.data
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(a, dtype):
    a = np.asarray(a, np.float32)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return jnp.asarray(a).astype(jnp.dtype(dtype)), torch.from_numpy(a).to(
        tdt)


# --------------------------- split flash backward ----------------------------


def _attention_case(seed, B, L, H, D, causal, dtype):
    """Inputs, a forward's (out, lse) and the port's delta; both backwards
    take the same out and lse (the port's plain forward's: the forwards
    are held against each other in test_torch_kernels.py)."""
    rng = np.random.default_rng(seed)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _pair(rng.normal(size=(B, L, H, D)), dtype) for _ in range(4))
    scale = 1.0 / np.sqrt(D)
    tout, tlse = fa.flash_attention_plain(tq, tk, tv, causal, scale)
    jout = jnp.asarray(_np(tout)).astype(jq.dtype)
    return ((jq, jk, jv, jout, jnp.asarray(_np(tlse)), jdo),
            (tq, tk, tv, tlse, fa.attention_delta(tout, tdo), tdo), scale)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("L", [100, 128, 192])
def test_split_plain_versions_match_pallas(L, causal):
    """dq and (dk, dv) against the reference's split backward in the
    Pallas interpreter with 64-row blocks: several q and k blocks, and
    ragged tails at 100."""
    (jq, jk, jv, jout, jlse, jdo), targs, scale = _attention_case(
        L + causal, 2, L, 2, 32, causal, "float32")
    want = jfa._fa_bwd_pallas(jq, jk, jv, jout, jlse, jdo, None, causal,
                              scale, interpret=True, blocks=(64, 64))
    dq = fa.flash_attention_bwd_dq_plain(*targs, causal, scale)
    dk, dv = fa.flash_attention_bwd_dkv_plain(*targs, causal, scale)
    for name, g, w in zip("q k v".split(), (dq, dk, dv), want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(w), atol=BWD_ATOL, rtol=0,
                                   err_msg=f"d{name}")


def test_split_plain_versions_match_pallas_bf16():
    (jq, jk, jv, jout, jlse, jdo), targs, scale = _attention_case(
        7, 2, 100, 2, 32, True, "bfloat16")
    want = jfa._fa_bwd_pallas(jq, jk, jv, jout, jlse, jdo, None, True,
                              scale, interpret=True, blocks=(64, 64))
    dq = fa.flash_attention_bwd_dq_plain(*targs, True, scale)
    dk, dv = fa.flash_attention_bwd_dkv_plain(*targs, True, scale)
    for name, g, w in zip("q k v".split(), (dq, dk, dv), want):
        assert g.dtype == torch.bfloat16
        w = _np(w)
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=BF16_REL * np.abs(w).max(),
                                   err_msg=f"d{name}")


def test_gate_is_the_references():
    """The port's constant and test are the reference's (l.955, 1109): at
    D = 64 the split pair runs from 24,577 tokens on."""
    assert fa._FUSED_BWD_DQ_BYTES == jfa._FUSED_BWD_DQ_BYTES
    for Lq, D in ((1024, 64), (24576, 64), (24577, 64), (32768, 64),
                  (12288, 128), (12289, 128)):
        assert fa.uses_split_bwd(Lq, D) == (
            not Lq * D * 4 <= jfa._FUSED_BWD_DQ_BYTES), (Lq, D)
    assert not fa.uses_split_bwd(24576, 64) and fa.uses_split_bwd(32768, 64)


@pytest.mark.parametrize("causal", [True, False])
def test_routing_above_the_gate_runs_the_split_pair(monkeypatch, causal):
    """With the gate lowered below Lq * D * 4, the attention Function's
    backward runs the split plain versions (counters) and gives the
    one-pass plain version's gradients."""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, 40, 2, 16)).astype(
        np.float32)) for _ in range(4))

    def grads():
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (fa.flash_attention(*leaves, causal=causal) * do).sum().backward()
        return [t.grad for t in leaves]

    kernels.reset_stats()
    fused = grads()
    monkeypatch.setattr(fa, "_FUSED_BWD_DQ_BYTES", 40 * 16 * 4 - 1)
    split = grads()
    st = kernels.all_stats()
    assert st["flash_attention_bwd"] == {"kernel": 0, "plain": 1}
    assert st["flash_attention_bwd_dq"] == {"kernel": 0, "plain": 1}
    assert st["flash_attention_bwd_dkv"] == {"kernel": 0, "plain": 1}
    for a, b in zip(split, fused):
        assert torch.equal(a, b)


# --------------------------------- recompute ---------------------------------


def test_recompute_finds_layers_in_closures_and_ignores_reentrant():
    """recompute(lambda a: net(a), x) threads the closed-over layer's
    parameters (reference tests/test_recompute_sharding.py); the gradients
    equal the plain run's, use_reentrant=True included."""
    torch.manual_seed(0)
    net = nn.Linear(8, 8, device="cpu")
    x = torch.randn(4, 8, requires_grad=True)
    (net(x) ** 2).sum().backward()
    want = [t.grad.clone() for t in (x, net.weight, net.bias)]
    for t in (x, net.weight, net.bias):
        t.grad = None
    out = recompute(lambda a: net(a), x, use_reentrant=True,
                    policy=recompute_policies.dots)
    (out ** 2).sum().backward()
    for t, w in zip((x, net.weight, net.bias), want):
        assert torch.equal(t.grad, w)


# ------------------------------- GPT remat -----------------------------------


def _gpt_batch(B=2, L=32):
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 1024, (B, L)).astype(np.int32)
    labels = rng.integers(0, 1024, (B, L)).astype(np.int32)
    labels[0, :3] = -100
    return ids, labels


def _gpt_weights():
    paddle.seed(0)
    jm = JGPT(JConfig.tiny())
    return {k: np.asarray(p.data) for k, p in jm.named_parameters()}


def _port_gpt_step(params, remat, amp_dtype=None, dropout=0.0, seed=0):
    """(loss, {name: gradient}, kernel counters) of one port TrainStep."""
    cfg = GPTConfig.tiny()
    cfg.remat, cfg.dropout = remat, dropout
    tm = GPT(cfg, device="cpu")
    load_numpy_params(tm, params)
    tst = jit.TrainStep(tm, F.cross_entropy, optimizer.AdamW(
        learning_rate=LR, parameters=tm.parameters(), weight_decay=0.01),
        amp_dtype=amp_dtype)
    grads = {}
    apply_fn = tst.optimizer.apply_fn

    def record(p, g, state, **kw):
        grads.update({k: v.clone() for k, v in g.items()})
        return apply_fn(p, g, state, **kw)

    tst.optimizer.apply_fn = record
    ids, labels = _gpt_batch()
    torch.manual_seed(seed)
    kernels.reset_stats()
    loss = tst(torch.from_numpy(ids.astype(np.int64)),
               torch.from_numpy(labels.astype(np.int64)))
    return float(loss), grads, kernels.all_stats()


@pytest.mark.parametrize("remat", ["", "dots", "full"])
def test_gpt_remat_train_step_matches_reference(remat):
    """One fp32 TrainStep (AdamW) with the same remat in both packages: the
    loss and every gradient (the reference's read back from its first
    moment, (1 - beta1) * g after one step). Each block's flash forward and
    both layer norms run again in the backward under either policy, as the
    reference re-runs its custom-vjp flash forward."""
    params = _gpt_weights()
    jcfg = JConfig.tiny()
    jcfg.remat = remat
    paddle.seed(0)
    jm = JGPT(jcfg)
    jst = JTrainStep(jm, JF.cross_entropy, jopt.AdamW(
        learning_rate=LR, parameters=jm.parameters(), weight_decay=0.01),
        fused_opt=False)
    ids, labels = _gpt_batch()
    jl = float(_np(jst(paddle.to_tensor(ids), paddle.to_tensor(labels))))
    tl, tg, st = _port_gpt_step(params, remat)
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    assert set(tg) == set(jst.opt_state)
    for k, g in tg.items():
        want = _np(jst.opt_state[k]["moment1"]) / (1 - 0.9)
        np.testing.assert_allclose(_np(g), want, atol=BWD_ATOL, rtol=0,
                                   err_msg=k)
    replays = 2 if remat else 0  # tiny: two blocks
    assert st["flash_attention"] == {"kernel": 0, "plain": 2 + replays}
    assert st["layer_norm"] == {"kernel": 0, "plain": 5 + 2 * replays}
    assert st["flash_attention_bwd"] == {"kernel": 0, "plain": 2}


@pytest.mark.parametrize("amp_dtype,dropout", [(None, 0.0),
                                               (torch.bfloat16, 0.0),
                                               (None, 0.1),
                                               (torch.bfloat16, 0.1)])
def test_gpt_remat_gives_the_no_remat_step(amp_dtype, dropout):
    """Inside the port, "dots" and "full" give the no-remat loss and
    gradients bit for bit: under O2 bf16 (the replay must run on the
    step's bf16 casts, not the module's fp32 masters, which
    functional_call has restored by the time the backward runs), and with
    dropout 0.1 (the replay draws the forward's masks again)."""
    params = _gpt_weights()
    base_loss, base, _ = _port_gpt_step(params, "", amp_dtype, dropout)
    if dropout:
        other, _, _ = _port_gpt_step(params, "", amp_dtype, dropout, seed=1)
        assert other != base_loss  # dropout is live
    for remat in ("dots", "full"):
        loss, grads, _ = _port_gpt_step(params, remat, amp_dtype, dropout)
        assert loss == base_loss, remat
        for k, g in grads.items():
            assert g.dtype == torch.float32
            assert torch.equal(g, base[k]), (remat, k)


def test_gpt_config_remat_and_presets():
    with pytest.raises(ValueError, match="remat"):
        GPTConfig(remat="x")
    for name in ("gpt3_1p3b", "gpt3_6p7b"):
        got, want = getattr(GPTConfig, name)(), getattr(JConfig, name)()
        for field in ("hidden_size", "num_layers", "num_heads",
                      "max_position_embeddings", "intermediate_size",
                      "vocab_size", "remat"):
            assert getattr(got, field) == getattr(want, field), (name, field)
    # eval mode runs the blocks directly: nothing to replay
    cfg = GPTConfig.tiny()
    cfg.remat = "full"
    m = GPT(cfg, device="cpu")
    m.eval()
    with torch.no_grad():
        m(torch.ones(1, 8, dtype=torch.long))


# ---------------------------- ResNet recompute -------------------------------


def _rel_l2(got, want):
    """(whole relative L2, worst leaf's) of {name: array} pairs."""
    num = den = leaf = 0.0
    for k, w in want.items():
        g, w = _np(got[k]), _np(w)
        d2, n2 = float(np.sum((g - w) ** 2)), float(np.sum(w ** 2))
        num, den = num + d2, den + n2
        leaf = max(leaf, (d2 / max(n2, 1e-60)) ** 0.5)
    return (num / den) ** 0.5, leaf


def _port_resnet_step(arrays, x, y, recompute_on):
    tm = tresnet.resnet18(num_classes=10, data_format="NHWC", device="cpu",
                          recompute=recompute_on)
    load_numpy_params(tm, arrays)
    tst = jit.TrainStep(tm, F.cross_entropy, optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=tm.parameters()))
    kernels.reset_stats()
    loss = float(tst(torch.from_numpy(x), torch.from_numpy(
        y.astype(np.int64))))
    return (loss, {k: s["velocity"] for k, s in tst.opt_state.items()},
            tst.buffers, kernels.all_stats())


def test_resnet_recompute_matches_reference_and_moves_stats_once():
    """resnet18 (NHWC, 10 classes) with recompute=True, one fp32 TrainStep
    (Momentum(0.1, 0.9)) at B 2, 64x64 in both packages: loss, every
    gradient (the velocity after one step) and every running statistic.
    The port's stage BNs run again in the backward, and their statistics
    still move once: the step equals the port's recompute=False step.

    Not 32x32: there layer4's batch norms see 2 rows a channel, which they
    normalise to +-1, and the two packages' steps differ by 56 % in
    relative L2 without recompute already; at 64x64 (8 rows) they agree
    to 2e-5, with or without it."""
    paddle.seed(0)
    jm = jresnet.resnet18(num_classes=10, data_format="NHWC", recompute=True)
    arrays = {k: np.asarray(v.data) for k, v in jm.named_parameters()}
    arrays.update({k: np.asarray(v.data) for k, v in jm.named_buffers()})
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    y = np.array([3, 7], np.int32)
    jst = JTrainStep(jm, JF.cross_entropy, jopt.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=jm.parameters()))
    jl = float(_np(jst(paddle.to_tensor(x), paddle.to_tensor(y))))
    jgrads = {k: s["velocity"] for k, s in jst.opt_state.items()}

    tl, tg, tb, st = _port_resnet_step(arrays, x, y, True)
    assert abs(tl - jl) <= 1e-3 * abs(jl)
    whole, leaf = _rel_l2(tg, jgrads)
    assert whole <= 0.10 and leaf <= 0.15, (whole, leaf)
    assert set(tb) == set(jst.buffers)
    for k, v in jst.buffers.items():
        w = _np(v)
        np.testing.assert_allclose(_np(tb[k]), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max(), err_msg=k)
    # 17 fused BNs (the stem and 2 a block); the 16 in the stages replay
    assert st["fused_bn_fwd"] == {"kernel": 0, "plain": 17 + 16}
    assert st["fused_bn_bwd_dx"] == {"kernel": 0, "plain": 17}

    pl, pg, pb, _ = _port_resnet_step(arrays, x, y, False)
    assert tl == pl
    for k in pg:
        assert torch.equal(tg[k], pg[k]), k
    moved = 0
    for k in pb:
        assert torch.equal(tb[k], pb[k]), k
        moved += not np.array_equal(_np(pb[k]), arrays[k])
    assert moved == len(pb)
