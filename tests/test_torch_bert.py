"""The port's transformer layers, fused incubate layers, BERT and ERNIE
(paddle_tpu_torch.nn.transformer, incubate.nn, models.bert, models.ernie)
against the JAX package on the CPU, at tiny widths.

Both packages are built from the same numpy weights (the reference's,
loaded strictly into the port by ``utils.convert.load_numpy_params``) and
fed the same inputs from a numpy seed. The JAX side runs as its own tests
run it on the CPU (its XLA compositions; the flash small path in the
Pallas interpreter where a test calls it directly), the port its plain
versions through the same autograd Functions a card uses.

Tolerances: single layers fp32 atol 1e-5 (sums in another order); whole
models and training steps fp32 atol 1e-4; the O2 bf16 loss atol 2e-2 (bf16
rounding of activations and logits of a loss near 0.7); the non-causal
flash plain versions at BERT's head dim 64 against the small-path Pallas
kernels, fp32 atol 2e-5 forward and 1e-5 backward, as in
``tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.incubate import nn as jinc
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import ernie as jernie
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch import jit, nn, optimizer
from paddle_tpu_torch.incubate import nn as inc
from paddle_tpu_torch.models import bert, ernie
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.utils.convert import load_numpy_params

LAYER_ATOL = 1e-5
MODEL_ATOL = 1e-4
CPU = dict(device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(getattr(x, "data", x), np.float32)


def _jt(a, dtype=np.float32):
    return paddle.to_tensor(np.asarray(a, dtype))


def _tt(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _load(jlayer, tlayer):
    """The reference's parameters into the port's layer, strictly."""
    load_numpy_params(tlayer, {k: np.asarray(p.data)
                               for k, p in jlayer.named_parameters()})
    return tlayer


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0,
                               err_msg=msg)


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------ MultiHeadAttention ---------------------------


def _masks(rng, B, Lq, Lk):
    keep = rng.random((B, 1, Lq, Lk)) > 0.3
    keep[..., 0] = True  # every row sees a key
    return {"none": (None, None),
            "bool": (paddle.to_tensor(keep), torch.from_numpy(keep)),
            "additive": (_jt(np.where(keep, 0.0, -1e4)),
                         _tt(np.where(keep, 0.0, -1e4)))}


@pytest.mark.parametrize("mask", ["none", "bool", "additive"])
def test_multihead_attention_matches_reference(mask):
    """Self- and cross-attention (kdim, vdim) with no mask, a bool mask
    and an additive mask; need_weights gives None as the reference's."""
    rng = np.random.default_rng(0)
    B, Lq, Lk, E = 2, 10, 14, 32
    paddle.seed(0)
    jm = jnn.MultiHeadAttention(E, 4, kdim=24, vdim=20, need_weights=True)
    tm = _load(jm, nn.MultiHeadAttention(E, 4, kdim=24, vdim=20,
                                         need_weights=True, **CPU))
    q, k, v = _x(rng, B, Lq, E), _x(rng, B, Lk, 24), _x(rng, B, Lk, 20)
    jmask, tmask = _masks(rng, B, Lq, Lk)[mask]
    kernels.reset_stats()
    jout, jw = jm(_jt(q), _jt(k), _jt(v), jmask)
    tout, tw = tm(_tt(q), _tt(k), _tt(v), tmask)
    assert jw is None and tw is None
    _close(tout, jout, LAYER_ATOL)
    # a 4-D bool mask takes the flash kernels (their masked plain
    # versions here), an additive one composes, as in the reference
    composed = kernels.composed_stats()["flash_attention"]
    assert composed == (1 if mask == "additive" else 0)
    masked = kernels.all_stats()["flash_attention_masked"]["plain"]
    assert masked == (1 if mask == "bool" else 0)


def test_multihead_attention_caches_match_reference():
    """Incremental decoding through a Cache (three steps, the keys and
    values growing) and cross attention through a StaticCache."""
    rng = np.random.default_rng(1)
    B, E, Lm = 2, 32, 9
    paddle.seed(1)
    jm = jnn.MultiHeadAttention(E, 4)
    tm = _load(jm, nn.MultiHeadAttention(E, 4, **CPU))
    mem = _x(rng, B, Lm, E)
    jc = jm.gen_cache(_jt(mem))
    tc = tm.gen_cache(_tt(mem))
    assert tuple(tc.k.shape) == (B, 0, 4, 8)
    for step in range(3):
        x = _x(rng, B, 1, E)
        jout, jc = jm(_jt(x), cache=jc)
        tout, tc = tm(_tt(x), cache=tc)
        assert isinstance(tc, nn.MultiHeadAttention.Cache)
        assert tuple(tc.k.shape) == (B, step + 1, 4, 8)
        _close(tout, jout, LAYER_ATOL, f"step {step}")
    js = jm.gen_cache(_jt(mem), type=jnn.MultiHeadAttention.StaticCache)
    ts = tm.gen_cache(_tt(mem), type=nn.MultiHeadAttention.StaticCache)
    _close(ts.k, js.k, LAYER_ATOL)
    x = _x(rng, B, 5, E)
    _close(tm(_tt(x), cache=ts), jm(_jt(x), cache=js), LAYER_ATOL)


# ------------------------------ encoder / decoder ----------------------------


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_layer_and_stack_match_reference(normalize_before):
    """TransformerEncoderLayer (GELU) both ways, a 3-layer stack of deep
    copies with a final norm, and its output gradient on the input."""
    rng = np.random.default_rng(2)
    paddle.seed(2)
    args = (32, 4, 64)
    kw = dict(dropout=0.0, activation="gelu",
              normalize_before=normalize_before)
    jl = jnn.TransformerEncoderLayer(*args, **kw)
    jenc = jnn.TransformerEncoder(jl, 3, norm=jnn.LayerNorm(32))
    tl = nn.TransformerEncoderLayer(*args, **kw, **CPU)
    tenc = _load(jenc, nn.TransformerEncoder(
        tl, 3, norm=nn.LayerNorm(32, **CPU)))
    names = [k for k, _ in tenc.named_parameters()]
    assert names == [k for k, _ in jenc.named_parameters()]
    # the stack's layers start from one layer's weights
    for p0, p2 in zip(tenc.layers[0].parameters(),
                      tenc.layers[2].parameters()):
        assert p0 is not p2
    x = _x(rng, 2, 12, 32)
    _close(tl(_tt(x)), jl(_jt(x)), LAYER_ATOL)
    tx = _tt(x).requires_grad_(True)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tout = tenc(tx)
    jout = jenc(jx)
    _close(tout, jout, LAYER_ATOL)
    tout.sum().backward()
    jout.sum().backward()
    _close(tx.grad, jx.grad, LAYER_ATOL)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_with_subsequent_mask_matches_reference(
        normalize_before):
    """Transformer (2 + 2 layers) with generate_square_subsequent_mask on
    the decoder's self-attention: the mask (0 on and below the diagonal,
    -inf above) and the output."""
    rng = np.random.default_rng(3)
    paddle.seed(3)
    kw = dict(d_model=32, nhead=4, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=64, dropout=0.0,
              normalize_before=normalize_before)
    jt = jnn.Transformer(**kw)
    tt = _load(jt, nn.Transformer(**kw, **CPU))
    jmask = jt.generate_square_subsequent_mask(7)
    tmask = tt.generate_square_subsequent_mask(7)
    assert tmask.dtype == torch.float32
    np.testing.assert_array_equal(_np(tmask), _np(jmask))
    src, tgt = _x(rng, 2, 9, 32), _x(rng, 2, 7, 32)
    kernels.reset_stats()
    _close(tt(_tt(src), _tt(tgt), tgt_mask=tmask),
           jt(_jt(src), _jt(tgt), tgt_mask=jmask), MODEL_ATOL)
    assert kernels.composed_stats()["flash_attention"] == 2  # masked self


def test_decoder_with_caches_matches_reference():
    """TransformerDecoder decoding token by token through gen_cache (an
    incremental Cache for self-attention, a StaticCache over memory)."""
    rng = np.random.default_rng(4)
    paddle.seed(4)
    jl = jnn.TransformerDecoderLayer(32, 4, 64, dropout=0.0)
    jdec = jnn.TransformerDecoder(jl, 2)
    tdec = _load(jdec, nn.TransformerDecoder(
        nn.TransformerDecoderLayer(32, 4, 64, dropout=0.0, **CPU), 2))
    mem = _x(rng, 2, 6, 32)
    jc = jdec.gen_cache(_jt(mem))
    tc = tdec.gen_cache(_tt(mem))
    for step in range(3):
        x = _x(rng, 2, 1, 32)
        jout, jc = jdec(_jt(x), _jt(mem), cache=jc)
        tout, tc = tdec(_tt(x), _tt(mem), cache=tc)
        _close(tout, jout, LAYER_ATOL, f"step {step}")


# ------------------------------ incubate.nn ----------------------------------


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("layer", ["attention", "feedforward", "encoder"])
def test_fused_layers_match_reference(layer, pre):
    """FusedMultiHeadAttention (unmasked, causal and with an additive
    mask), FusedFeedForward (GELU) and FusedTransformerEncoderLayer, with
    pre_layer_norm both ways: outputs and input gradients."""
    rng = np.random.default_rng(5)
    paddle.seed(5)
    E = 32
    if layer == "attention":
        kw = dict(dropout_rate=0.0, attn_dropout_rate=0.0,
                  normalize_before=pre)
        jm, tm = (jinc.FusedMultiHeadAttention(E, 4, **kw),
                  inc.FusedMultiHeadAttention(E, 4, **kw, **CPU))
    elif layer == "feedforward":
        kw = dict(dropout_rate=0.0, activation="gelu", normalize_before=pre)
        jm, tm = (jinc.FusedFeedForward(E, 64, **kw),
                  inc.FusedFeedForward(E, 64, **kw, **CPU))
    else:
        kw = dict(dropout_rate=0.0, normalize_before=pre)
        jm, tm = (jinc.FusedTransformerEncoderLayer(E, 4, 64, **kw),
                  inc.FusedTransformerEncoderLayer(E, 4, 64, **kw, **CPU))
    _load(jm, tm)
    x = _x(rng, 2, 12, E)
    add = np.where(rng.random((2, 4, 12, 12)) > 0.3, 0.0, -1e4)
    masks = [(None, None)]
    if layer == "attention":
        masks += [("causal", "causal"), (_jt(add), _tt(add))]
    for jmask, tmask in masks:
        tx = _tt(x).requires_grad_(True)
        jx = paddle.to_tensor(x, stop_gradient=False)
        extra = () if layer == "feedforward" else (jmask,)
        jout = jm(jx, *extra) if layer != "attention" else jm(
            jx, attn_mask=jmask)
        textra = () if layer == "feedforward" else (tmask,)
        tout = tm(tx, *textra) if layer != "attention" else tm(
            tx, attn_mask=tmask)
        _close(tout, jout, LAYER_ATOL, str(jmask is None))
        tout.sum().backward()
        jout.sum().backward()
        _close(tx.grad, jx.grad, LAYER_ATOL)


def test_fused_residual_dropout_ln():
    """LN(residual + dropout(x)): without dropout the layer norm of the
    sum; with p = 0.5 every element of dropout(x) is 0 or 2x."""
    from paddle_tpu_torch.ops.kernels import layer_norm as ln
    rng = np.random.default_rng(6)
    x, r = _tt(_x(rng, 4, 16)), _tt(_x(rng, 4, 16))
    g, b = torch.ones(16), torch.zeros(16)
    _close(ln.fused_residual_dropout_ln(x, r, g, b),
           torch.nn.functional.layer_norm(x + r, (16,), g, b, 1e-5), 1e-5)
    gen = torch.Generator().manual_seed(0)
    eval_out = ln.fused_residual_dropout_ln(x, r, g, b, p=0.5,
                                            training=False)
    _close(eval_out, ln.fused_residual_dropout_ln(x, r, g, b), 0.0)
    out = ln.fused_residual_dropout_ln(x, r, g, b, p=0.5, generator=gen)
    assert not torch.allclose(out, eval_out)


# ----------------------------------- BERT ------------------------------------


def _bert_pair(cls_j, cls_t, cfg_j, cfg_t, seed=0):
    paddle.seed(seed)
    jm = cls_j(cfg_j)
    return jm, _load(jm, cls_t(cfg_t, **CPU))


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("with_types", [False, True])
def test_bert_outputs_match_reference(with_mask, with_types):
    """Bert's sequence and pooled outputs, with and without an
    attention_mask (padding at the end of row 1: the reference's
    additive [B, 1, 1, L] mask, composed and counted) and
    token_type_ids."""
    jm, tm = _bert_pair(jbert.Bert, bert.Bert, jbert.BertConfig.tiny(),
                        bert.BertConfig.tiny())
    rng = np.random.default_rng(7)
    B, L = 2, 24
    ids = rng.integers(0, 1000, (B, L)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if with_types:
        types = (np.arange(L) >= L // 2).astype(np.int32)[None].repeat(B, 0)
        kw_j["token_type_ids"] = _jt(types, np.int32)
        kw_t["token_type_ids"] = _tt(types, torch.long)
    if with_mask:
        m = np.ones((B, L), np.int32)
        m[1, 17:] = 0
        kw_j["attention_mask"] = _jt(m, np.int32)
        kw_t["attention_mask"] = _tt(m, torch.long)
    kernels.reset_stats()
    jseq, jpool = jm(_jt(ids, np.int32), **kw_j)
    tseq, tpool = tm(_tt(ids, torch.long), **kw_t)
    _close(tseq, jseq, MODEL_ATOL)
    _close(tpool, jpool, MODEL_ATOL)
    stats = kernels.all_stats()
    assert stats["layer_norm"]["plain"] == 1 + 2 * 2
    composed = kernels.composed_stats()["flash_attention"]
    assert composed == (2 if with_mask else 0)
    assert stats["flash_attention"]["plain"] == (0 if with_mask else 2)


def test_bert_for_pretraining_matches_reference():
    """BertForPretraining's MLM and NSP logits; the names load strictly."""
    jm, tm = _bert_pair(jbert.BertForPretraining, bert.BertForPretraining,
                        jbert.BertConfig.tiny(), bert.BertConfig.tiny())
    ids = np.random.default_rng(8).integers(0, 1000, (2, 16))
    jmlm, jnsp = jm(_jt(ids, np.int32))
    tmlm, tnsp = tm(_tt(ids, torch.long))
    assert tuple(tmlm.shape) == (2, 16, 1000) and tuple(tnsp.shape) == (2, 2)
    _close(tmlm, jmlm, MODEL_ATOL)
    _close(tnsp, jnsp, MODEL_ATOL)


class _JBertCls(jnn.Layer):
    """bench.py's classifier: BERT and a 2-way head on the pooled output."""

    def __init__(self, cfg):
        super().__init__()
        self.bert = jbert.Bert(cfg)
        self.head = jnn.Linear(cfg.hidden_size, 2)

    def forward(self, ids):
        return self.head(self.bert(ids)[1])


class _BertCls(nn.Layer):
    def __init__(self, cfg, device=None):
        super().__init__(device)
        self.bert = bert.Bert(cfg, device=device)
        self.head = nn.Linear(cfg.hidden_size, 2, device=device)
        self.name_parameters()

    def forward(self, ids):
        return self.head(self.bert(ids)[1])


def _cls_batch(seed, B=4, L=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1000, (B, L)).astype(np.int32)
    labels = rng.integers(0, 2, (B,)).astype(np.int32)
    return ((_jt(ids, np.int32), _jt(labels, np.int32)),
            (_tt(ids, torch.long), _tt(labels, torch.long)))


def _cls_steps(amp, lr):
    jm, tm = _bert_pair(_JBertCls, _BertCls, jbert.BertConfig.tiny(),
                        bert.BertConfig.tiny())
    jst = JTrainStep(jm, JF.cross_entropy, jopt.AdamW(
        learning_rate=lr, parameters=jm.parameters(), weight_decay=0.01),
        amp_dtype=jnp.bfloat16 if amp else None, fused_opt=False)
    tst = jit.TrainStep(tm, F.cross_entropy, optimizer.AdamW(
        learning_rate=lr, parameters=tm.parameters(), weight_decay=0.01),
        amp_dtype=torch.bfloat16 if amp else None)
    return jst, tst, lr


def test_bert_classifier_train_step_fp32_matches_reference():
    """One fp32 TrainStep (AdamW) of bench.py's BERT classifier: the loss,
    every gradient (read back from the reference's first moment, m1 =
    (1 - beta1) g) and every parameter after the update, against the
    reference's TrainStep(fused_opt=False)."""
    jst, tst, lr = _cls_steps(amp=False, lr=1e-3)
    grads = {}
    apply_fn = tst.optimizer.apply_fn

    def record(params, g, state, **kw):
        grads.update({k: v.clone() for k, v in g.items()})
        return apply_fn(params, g, state, **kw)

    tst.optimizer.apply_fn = record
    ja, ta = _cls_batch(0)
    np.testing.assert_allclose(float(tst(*ta)), float(jst(*ja).data),
                               atol=MODEL_ATOL)
    assert set(grads) == set(jst.params)
    for k, g in grads.items():
        want = _np(jst.opt_state[k]["moment1"]) / (1 - 0.9)
        _close(g, want, MODEL_ATOL, k)
    for k, p in jst.params.items():
        # a first Adam step moves an element by about lr * sign(g): an
        # element whose gradient is rounding noise may move either way
        live = np.abs(_np(jst.opt_state[k]["moment1"])) > 1e-7
        got, want = _np(tst.params[k]), _np(p)
        np.testing.assert_allclose(got[live], want[live], atol=MODEL_ATOL,
                                   rtol=0, err_msg=k)
        np.testing.assert_allclose(got, want, atol=2 * lr + MODEL_ATOL,
                                   rtol=0, err_msg=k)


def test_bert_classifier_train_step_o2_bf16_tracks_reference():
    """Two O2 bf16 steps at bench.py's lr 1e-4: the losses within 2e-2 of
    the reference's, the second below the first on one batch, and each
    step's launches: 5
    layer norms, 2 attentions forward and backward and one CE (plain
    versions here)."""
    jst, tst, _ = _cls_steps(amp=True, lr=1e-4)
    ja, ta = _cls_batch(1)
    kernels.reset_stats()
    losses = []
    for _ in range(2):
        tl = tst(*ta)
        assert tl.dtype == torch.float32
        losses.append(float(tl))
        np.testing.assert_allclose(losses[-1], float(jst(*ja).data),
                                   atol=2e-2)
    assert losses[1] < losses[0]
    stats = kernels.all_stats()
    for name, n in {"layer_norm": 5, "layer_norm_bwd": 5,
                    "flash_attention": 2,
                    "flash_attention_bwd": 2, "softmax_ce_fwd": 1,
                    "softmax_ce_bwd": 1}.items():
        assert stats[name] == {"kernel": 0, "plain": 2 * n}, name
    assert not any(kernels.composed_stats().values())


# ----------------------------------- ERNIE -----------------------------------


def test_ernie_mask_tokens_matches_reference():
    rng = np.random.default_rng(9)
    ids = rng.integers(5, 1024, (3, 20))
    spans = [[(1, 4), (10, 12)], [], [(0, 20)]]
    got = ernie.ernie_mask_tokens(ids, spans, mask_token_id=3)
    want = jernie.ernie_mask_tokens(ids, spans, mask_token_id=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1][1] == -100).all() and (got[0][2] == 3).all()


def test_ernie_pretraining_loss_matches_reference():
    """ErnieForPretraining.loss over knowledge-masked spans (the rest at
    ignore_index -100), and the gradient of every parameter."""
    paddle.seed(10)
    jm = jernie.ErnieForPretraining(jernie.ErnieConfig.tiny())
    tm = _load(jm, ernie.ErnieForPretraining(ernie.ErnieConfig.tiny(),
                                             **CPU))
    rng = np.random.default_rng(10)
    raw = rng.integers(5, 1024, (2, 32)).astype(np.int32)
    spans = [[(2, 6), (20, 23)], [(0, 3), (9, 15), (30, 32)]]
    ids, labels = ernie.ernie_mask_tokens(raw, spans, mask_token_id=3)
    kernels.reset_stats()
    jloss = jm.loss(_jt(ids, np.int32), _jt(labels, np.int32))
    tloss = tm.loss(_tt(ids, torch.long), _tt(labels, torch.long))
    _close(tloss, jloss, MODEL_ATOL)
    assert kernels.all_stats()["softmax_ce_fwd"]["plain"] == 1
    jloss.backward()
    tloss.backward()
    jp = dict(jm.named_parameters())
    for k, p in tm.named_parameters():
        _close(p.grad, jp[k].grad, MODEL_ATOL, k)


def test_ernie_train_step_with_an_unused_pooler_matches_reference():
    """One fp32 TrainStep of ErnieForPretraining, whose MLM loss never
    reaches the encoder's pooler: the pooler gets a zero gradient (as
    jax.grad gives it), so AdamW only decays it, and the loss and every
    parameter after the step match the reference's TrainStep."""
    paddle.seed(11)
    jm = jernie.ErnieForPretraining(jernie.ErnieConfig.tiny())
    tm = _load(jm, ernie.ErnieForPretraining(ernie.ErnieConfig.tiny(),
                                             **CPU))
    rng = np.random.default_rng(11)
    raw = rng.integers(5, 1024, (2, 32)).astype(np.int32)
    ids, labels = ernie.ernie_mask_tokens(raw, [[(1, 5)], [(8, 12)]], 3)
    lr = 1e-3
    jst = JTrainStep(jm, JF.cross_entropy, jopt.AdamW(
        learning_rate=lr, parameters=jm.parameters(), weight_decay=0.01),
        fused_opt=False)
    tst = jit.TrainStep(tm, F.cross_entropy, optimizer.AdamW(
        learning_rate=lr, parameters=tm.parameters(), weight_decay=0.01))
    jloss = jst(_jt(ids, np.int32), _jt(labels, np.int32))
    tloss = tst(_tt(ids, torch.long), _tt(labels, torch.long))
    _close(tloss, jloss, MODEL_ATOL)
    pooler = "ernie.pooler.dense.weight"
    np.testing.assert_array_equal(_np(tst.opt_state[pooler]["moment1"]), 0)
    for k, p in jst.params.items():
        live = np.abs(_np(jst.opt_state[k]["moment1"])) > 1e-7
        got, want = _np(tst.params[k]), _np(p)
        np.testing.assert_allclose(got[live], want[live], atol=MODEL_ATOL,
                                   rtol=0, err_msg=k)
        np.testing.assert_allclose(got, want, atol=2 * lr + MODEL_ATOL,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(_np(tst.params[pooler]),
                               _np(jst.params[pooler]), atol=1e-7, rtol=0)


# ------------------------- the flash small path, L 128 -----------------------


def test_flash_plain_non_causal_l128_matches_small_path_pallas():
    """BERT's attention shape cut in batch and heads (L 128, D 64,
    non-causal): the forward and one-pass backward plain versions against
    the reference's whole-sequence kernels in the Pallas interpreter."""
    rng = np.random.default_rng(12)
    shape = (1, 128, 2, 64)
    q, k, v, do = (_x(rng, *shape) for _ in range(4))
    scale = 0.125
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jout, jlse = jfa._fa_small_fwd_pallas(jq, jk, jv, None, False, scale,
                                          interpret=True)
    want = jfa._fa_small_bwd_pallas(jq, jk, jv, jout, jlse, jdo, None,
                                    False, scale, interpret=True)
    tq, tk, tv, tdo = (_tt(a) for a in (q, k, v, do))
    out, lse = fa.flash_attention_fwd(tq, tk, tv, False, scale)
    _close(out, jout, 2e-5)
    _close(lse, jlse, 2e-5)
    got = fa.flash_attention_bwd(tq, tk, tv, out, lse, tdo, False, scale)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
