"""Positional calls written for the reference mean the same in the port:
``Adam``/``AdamW`` take the reference's ``lr_ratio``, ``lazy_mode``,
``multi_precision`` and ``name`` slots, and ``TrainStep`` its ``donate``
slot, so no later argument shifts into another slot. An option the port
does not implement raises. Held against the JAX package on the CPU."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu_torch import jit, nn, optimizer


def _no_bias(name):
    return "bias" not in name


def _loss(out, y):
    return (out - y).sum()


def _pair(seed=0):
    """A Linear(4, 3) in each package with the same weights, bias 1.0."""
    paddle.seed(seed)
    jl = jnn.Linear(4, 3)
    w = np.array(jl.weight.data)
    jl.bias.set_value(np.ones(3, np.float32))
    tl = nn.Linear(4, 3, device="cpu")
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w))
        tl.bias.fill_(1.0)
    x = np.random.default_rng(seed).normal(size=(2, 4)).astype(np.float32)
    return jl, tl, x, np.zeros((2, 3), np.float32)


def test_adamw_positional_decay_fun_matches_reference():
    """The reference's order puts lr_ratio in slot 7 and the decay function
    in slot 8: the bias is exempt from decay, so one step of lr 0.1 moves it
    from 1.0 to 0.90 (to 0.85 if it decayed, as when the slot shifted)."""
    jl, tl, x, y = _pair()
    jo = jopt.AdamW(0.1, 0.9, 0.999, 1e-8, jl.parameters(), 0.5, None,
                    _no_bias)
    to = optimizer.AdamW(0.1, 0.9, 0.999, 1e-8, tl.parameters(), 0.5, None,
                         _no_bias)
    js, ts = JTrainStep(jl, _loss, jo), jit.TrainStep(tl, _loss, to)
    js(paddle.to_tensor(x), paddle.to_tensor(y))
    ts(torch.from_numpy(x), torch.from_numpy(y))
    got = {k: v.detach().numpy() for k, v in ts.params.items()}
    ref = {k: np.asarray(v) for k, v in js.params.items()}
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["bias"], 0.9, rtol=0, atol=1e-6)


def test_adamw_positional_eager_step_equals_keyword():
    _, tl, x, y = _pair()
    _, kl, _, _ = _pair()
    pos = optimizer.AdamW(0.1, 0.9, 0.999, 1e-8, tl.parameters(), 0.5, None,
                          _no_bias, None, False, False, "adamw")
    kw = optimizer.AdamW(learning_rate=0.1, parameters=kl.parameters(),
                         weight_decay=0.5, apply_decay_param_fun=_no_bias)
    for layer, opt in ((tl, pos), (kl, kw)):
        _loss(layer(torch.from_numpy(x)), torch.from_numpy(y)).backward()
        opt.step()
    assert torch.equal(tl.weight, kl.weight) and torch.equal(tl.bias,
                                                             kl.bias)


@pytest.mark.parametrize("make", [
    lambda ps: optimizer.Adam(0.1, parameters=ps, lazy_mode=True),
    lambda ps: optimizer.Adam(0.1, 0.9, 0.999, 1e-8, ps, None, None, False,
                              True),
    lambda ps: optimizer.AdamW(0.1, parameters=ps, lazy_mode=True),
    lambda ps: optimizer.AdamW(0.1, parameters=ps, multi_precision=True),
    lambda ps: optimizer.AdamW(0.1, 0.9, 0.999, 1e-8, ps, 0.01,
                               lambda p: 0.5),
], ids=["adam_lazy", "adam_multi_precision_positional", "adamw_lazy",
        "adamw_multi_precision", "adamw_lr_ratio_positional"])
def test_unported_options_raise(make):
    with pytest.raises(NotImplementedError):
        make(nn.Linear(2, 2, device="cpu").parameters())


def test_adam_takes_the_reference_slots():
    """Adam's slots 7-10 (grad_clip, lazy_mode, multi_precision, name) at
    their defaults, positionally, update as the keyword call does."""
    _, tl, x, y = _pair()
    _, kl, _, _ = _pair()
    pos = optimizer.Adam(0.1, 0.9, 0.999, 1e-8, tl.parameters(), None, None,
                         False, False, "adam")
    kw = optimizer.Adam(learning_rate=0.1, parameters=kl.parameters())
    for layer, opt in ((tl, pos), (kl, kw)):
        _loss(layer(torch.from_numpy(x)), torch.from_numpy(y)).backward()
        opt.step()
    assert torch.equal(tl.weight, kl.weight) and torch.equal(tl.bias,
                                                             kl.bias)


def test_trainstep_takes_donate_in_slot_four():
    """TrainStep(layer, loss, opt, True) steps as the keyword form and as
    the reference's positional call; an amp type passed after donate lands
    in amp_dtype, not in health."""
    jl, tl, x, y = _pair()
    _, kl, _, _ = _pair()
    js = JTrainStep(jl, _loss, jopt.Adam(0.1, parameters=jl.parameters()),
                    True)
    pos = jit.TrainStep(tl, _loss, optimizer.Adam(
        0.1, parameters=tl.parameters()), True)
    kw = jit.TrainStep(kl, _loss, optimizer.Adam(
        0.1, parameters=kl.parameters()))
    for _ in range(2):
        jloss = float(np.asarray(js(paddle.to_tensor(x),
                                    paddle.to_tensor(y)).data))
        lp = pos(torch.from_numpy(x), torch.from_numpy(y))
        lk = kw(torch.from_numpy(x), torch.from_numpy(y))
        assert torch.equal(lp, lk)
        # fp32 sums of another order: a few ULPs of the loss
        np.testing.assert_allclose(float(lp), jloss, rtol=1e-5)
    for k in kw.params:
        assert torch.equal(pos.params[k], kw.params[k])
        # Adam's second normalised update scales the gradients' ULPs up
        np.testing.assert_allclose(pos.params[k].detach().numpy(),
                                   np.asarray(js.params[k]), rtol=0,
                                   atol=1e-5)
    lin = nn.Linear(4, 3, device="cpu")
    amp = jit.TrainStep(lin, _loss, optimizer.Adam(
        0.1, parameters=lin.parameters()), False, torch.bfloat16)
    assert amp.amp_dtype == torch.bfloat16
    assert amp._health_probe is None


# ---- C10-C12: the batch norms' and attention's name slots ----------------

def _bn_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 3, 4, 4)).astype(np.float32) * 2
    w = rng.random(3).astype(np.float32) + 0.5
    b = rng.normal(size=3).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("args,relu", [
    ((None, "relu"), False),        # slot 10 is the reference's name
    ((None, "bn_1"), False),
    ((None, None, "relu"), True),   # name, then act
    ((None, None, None, None), False),
], ids=["name_relu", "name_other", "act_relu", "residual_none"])
def test_batch_norm_positional_name_slot(args, relu):
    """C10: F.batch_norm(x, rm, rv, w, b, True, 0.9, 1e-5, "NCHW", *args)
    means in the port what it means in the reference: slot 10 is `name`."""
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.nn import functional as F
    x, w, b = _bn_inputs()
    jrm, jrv = paddle.to_tensor(np.zeros(3, np.float32)), \
        paddle.to_tensor(np.ones(3, np.float32))
    trm, trv = torch.zeros(3), torch.ones(3)
    ref = JF.batch_norm(paddle.to_tensor(x), jrm, jrv, paddle.to_tensor(w),
                        paddle.to_tensor(b), True, 0.9, 1e-5, "NCHW", *args)
    got = F.batch_norm(torch.from_numpy(x), trm, trv, torch.from_numpy(w),
                       torch.from_numpy(b), True, 0.9, 1e-5, "NCHW", *args)
    ref = np.asarray(ref.data)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert (ref.min() >= 0) == relu and (got.min().item() >= 0) == relu
    np.testing.assert_allclose(trm.numpy(), np.asarray(jrm.data), atol=1e-6)
    np.testing.assert_allclose(trv.numpy(), np.asarray(jrv.data), atol=1e-6)


@pytest.mark.parametrize("args,relu", [
    (("NCHW", None, "relu"), False),       # slot 7 is the reference's name
    (("NCHW", None, None, "relu"), True),  # name, then act
], ids=["name_relu", "act_relu"])
def test_batch_norm_layer_positional_name_slot(args, relu):
    """C11: BatchNorm2D(3, 0.9, 1e-5, None, None, *args)."""
    x, _, _ = _bn_inputs(1)
    jl = jnn.BatchNorm2D(3, 0.9, 1e-5, None, None, *args)
    tl = nn.BatchNorm2D(3, 0.9, 1e-5, None, None, *args, device="cpu")
    ref = np.asarray(jl(paddle.to_tensor(x)).data)
    got = tl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert (ref.min() >= 0) == relu and (got.min() >= 0) == relu


@pytest.mark.parametrize("args,relu", [
    (("NCHW", None, "relu"), False),       # slot 7 is the reference's name
    (("NCHW", None, None, "relu"), True),  # name, then act
], ids=["name_relu", "act_relu"])
def test_sync_batch_norm_layer_positional_name_slot(args, relu):
    """SyncBatchNorm(3, 0.9, 1e-5, None, None, *args), outside a group
    (the local batch's statistics, as the reference's eager use)."""
    x, _, _ = _bn_inputs(2)
    jl = jnn.SyncBatchNorm(3, 0.9, 1e-5, None, None, *args)
    tl = nn.SyncBatchNorm(3, 0.9, 1e-5, None, None, *args, device="cpu")
    ref = np.asarray(jl(paddle.to_tensor(x)).data)
    got = tl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert (ref.min() >= 0) == relu and (got.min() >= 0) == relu
    np.testing.assert_allclose(tl._mean.numpy(), np.asarray(jl._mean.data),
                               atol=1e-6)


def test_attention_positional_name_slot():
    """C12: F.scaled_dot_product_attention(q, k, v, None, p, False, True,
    "attn"): slot 7 is `name`; `generator` is keyword-only."""
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(2, 8, 2, 16)).astype(np.float32)
               for _ in range(3))
    jq, jk, jv = (paddle.to_tensor(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ref = np.asarray(JF.scaled_dot_product_attention(
        jq, jk, jv, None, 0.0, False, True, "attn").data)
    got = F.scaled_dot_product_attention(tq, tk, tv, None, 0.0, False, True,
                                         "attn")
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    ref = JF.scaled_dot_product_attention(jq, jk, jv, None, 0.1, False, True,
                                          "attn")
    got = F.scaled_dot_product_attention(tq, tk, tv, None, 0.1, False, True,
                                         "attn")
    assert tuple(got.shape) == tuple(ref.shape)
    assert torch.isfinite(got).all()
    with pytest.raises(TypeError):
        F.scaled_dot_product_attention(tq, tk, tv, None, 0.1, False, True,
                                       "attn", torch.Generator())
    a, b = (F.scaled_dot_product_attention(
        tq, tk, tv, dropout_p=0.1, generator=torch.Generator().manual_seed(3))
        for _ in range(2))
    assert torch.equal(a, b)


def test_data_parallel_and_new_group_take_the_reference_slots():
    """``DataParallel(layers, strategy, comm_buffer_size,
    last_comm_buffer_size, find_unused_parameters, group)`` and
    ``new_group(ranks, backend, timeout, axis_name)`` in the reference's
    order, positionally; a world of one rank over gloo."""
    import inspect
    import paddle_tpu.distributed as jdist
    from paddle_tpu_torch import distributed as tdist
    for name in ("DataParallel", "new_group", "all_reduce", "broadcast",
                 "all_gather", "reduce_scatter", "scatter", "alltoall",
                 "shard_batch", "replicate", "get_rank", "get_world_size"):
        want = list(inspect.signature(getattr(jdist, name)).parameters)
        got = list(inspect.signature(getattr(tdist, name)).parameters)
        assert got == want, name
    tdist.init_parallel_env(device="cpu")
    try:
        g = tdist.new_group([0], "gloo", 30)
        assert (g.ranks, g.backend, g.rank) == ([0], "gloo", 0)
        dp = tdist.DataParallel(nn.Linear(4, 3, device="cpu"), None, 5, 2,
                                True, g)
        assert (dp.comm_buffer_size, dp.last_comm_buffer_size,
                dp.find_unused_parameters, dp._group) == (5, 2, True, g)
        assert tdist.get_backend() == "gloo"
    finally:
        tdist.destroy_process_group()
    assert not tdist.is_initialized()


def test_group_sharded_parallel_takes_the_reference_slots():
    """``group_sharded_parallel(model, optimizer, level, scaler, group,
    offload, sync_buffers, buffer_max_size, segment_size, sync_comm,
    dp_group)`` and ``save_group_sharded_model(model, output, optimizer)``
    in the reference's order, positionally; each option the reference
    takes and ignores raises unless left at its default, and the
    reference's own raises (a level it does not know, offload) are the
    port's; a world of one rank over gloo."""
    import inspect
    from paddle_tpu.distributed import sharding as jsharding
    from paddle_tpu_torch import distributed as tdist
    from paddle_tpu_torch.distributed import sharding as tsharding
    from paddle_tpu_torch.distributed import topology
    for name in ("group_sharded_parallel", "save_group_sharded_model"):
        want = list(inspect.signature(getattr(jsharding, name)).parameters)
        got = list(inspect.signature(getattr(tsharding, name)).parameters)
        assert got == want, name
    assert tsharding.__all__ == jsharding.__all__
    tdist.init_parallel_env(device="cpu")
    try:
        g = tdist.new_group([0])

        def wrap(*args, **kw):
            topology.set_hybrid_communicate_group(None)
            _, tl, _, _ = _pair()
            return tsharding.group_sharded_parallel(
                tl, optimizer.Adam(0.1, parameters=tl.parameters()), *args,
                **kw)

        model, opt, scaler = wrap("os_g", None, g, False, False, 2 ** 23,
                                  2 ** 20, False, None)
        assert (opt.stage, opt.group, scaler) == (2, g, None)
        for args in (("zero",),):
            with pytest.raises(ValueError):
                wrap(*args)
        for args in (("os", None, None, True),
                     ("os", None, None, False, True),
                     ("os", None, None, False, False, 2 ** 22),
                     ("os", None, None, False, False, 2 ** 23, 2 ** 19),
                     ("os", None, None, False, False, 2 ** 23, 2 ** 20,
                      True),
                     ("os", None, None, False, False, 2 ** 23, 2 ** 20,
                      False, g)):
            with pytest.raises(NotImplementedError):
                wrap(*args)
        with pytest.raises(AssertionError):
            tsharding.save_group_sharded_model(model, "x.pdparams", opt)
    finally:
        topology.set_hybrid_communicate_group(None)
        tdist.destroy_process_group()
