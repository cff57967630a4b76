"""The port's synchronized batch norm against the JAX package's global-batch
batch norm.

The reference is one controller: under ``DataParallel`` its batch is
sharded over a ``dp`` mesh and a batch norm's statistics run over the
whole sharded array, i.e. the global batch's
(``tests/test_torch_data_parallel.py::
test_reference_batch_norm_under_data_parallel_is_global``). The port runs
one process a rank, and while a ``DataParallel`` forward or a grouped
``TrainStep`` runs, every training-mode batch norm all-reduces its
moments (forward) and its column sums (backward) over the group. One
2-rank gloo world (``tests/torch_dist_workers.py`` scenario
``resnet_dp``, started once for this module with a time limit of its
own) runs each case; the reference runs on a 2-device ``dp`` mesh.

Each route (unfused ``BatchNorm2D``, fused BN+ReLU with and without the
residual, the 1x1 conv + BN chain, ``SyncBatchNorm``, and the fused
layer's composed route with fp64 inputs) takes a per-pixel
cross-entropy over a global batch of 4 NHWC images, split 2 + 2 and
3 + 1 over the ranks. Under ``DataParallel`` the loss is the global
batch's mean and each rank's gradient its share times the group's size
(``parallel.group_loss``), so an input's gradient is 2 times the
reference's, and the reducer's average brings every parameter's back to
the reference's. Tolerances:
- losses, outputs, running statistics and gradients: 1e-5 of each
  tensor's largest magnitude (fp32 sums over 25-75 rows a rank and their
  all-reduce, in another order; 7.8e-7 seen);
- per-shard batch norm differs from the global one by more than 0.5 at
  some element (the shards' means are 3 apart);
- the tiny ResNet's Momentum step: the loss 1e-5 of itself, running
  statistics 1e-5 of each buffer's scale, each parameter's update within
  2e-4 of its leaf's largest update (three blocks of fp32 backward in
  another order; 2.8e-5 seen).
In a world of one the grouped path gives the local path's results bit for
bit: the moments travel as exact fp64 products with the row count.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import topology as jtopo
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.jit import functionalize as jfunctionalize
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import flatten as jflatten

import torch_dist_workers as workers

C = workers.BN_C
RANKS = 2
RTOL32 = 1e-5
GRAD_REL = 1e-5
STEP_GRAD_REL = 2e-4
LR = 0.1


def _close(got, want, rel, what=""):
    """|got - want| <= rel * max |want|."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = max(float(np.abs(w).max()), 1e-30)
    np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale, err_msg=what)


def _export(jlayer):
    out = {k: np.asarray(v.data) for k, v in jlayer.named_parameters()}
    out.update({k: np.asarray(v.data) for k, v in jlayer.named_buffers()})
    return out


class JChain(jnn.Layer):
    """The reference's 1x1 conv + BN+ReLU block tail."""

    def __init__(self):
        super().__init__()
        self.conv = jnn.Conv2D(2 * C, C, 1, bias_attr=False,
                               data_format="NHWC")
        self.bn = jnn.BatchNorm2D(C, act="relu", data_format="NHWC")

    def forward(self, x):
        return jresnet._conv_bn(self.conv, self.bn, x)


def _ref_layer(route):
    df = dict(data_format="NHWC")
    if route == "unfused":
        return jnn.BatchNorm2D(C, **df)
    if route == "sync":
        return jnn.SyncBatchNorm(C, **df)
    if route == "conv1x1":
        return JChain()
    return jnn.BatchNorm2D(C, act="relu", **df)


class JTiny(jnn.Layer):
    """workers.tiny_resnet in the reference."""

    def __init__(self):
        super().__init__()
        df = dict(data_format="NHWC")
        self.conv1 = jnn.Conv2D(3, 32, 3, padding=1, bias_attr=False, **df)
        self.bn1 = jnn.BatchNorm2D(32, act="relu", **df)
        self.block1 = jresnet.BottleneckBlock(32, 8, **df)
        self.block2 = jresnet.BottleneckBlock(32, 16, 2, jnn.Sequential(
            jnn.Conv2D(32, 64, 1, stride=2, bias_attr=False, **df),
            jnn.BatchNorm2D(64, **df)), **df)
        self.block3 = jresnet.BottleneckBlock(64, 16, **df)
        self.pool = jnn.AdaptiveAvgPool2D(1, data_format="NHWC")
        self.fc = jnn.Linear(64, 10)

    def forward(self, x):
        x = self.bn1(self.conv1(x))
        x = self.block3(self.block2(self.block1(x)))
        return self.fc(jflatten(self.pool(x), 1))


def _inputs():
    rng = np.random.default_rng(0)
    inp, layers = {}, {}
    for route in workers.BN_ROUTES:
        paddle.seed(1)
        layer = _ref_layer(route)
        bn = layer.bn if route == "conv1x1" else layer
        bn.weight.set_value((0.5 + rng.random(C)).astype(np.float32))
        bn.bias.set_value((0.2 * rng.normal(size=C)).astype(np.float32))
        layers[route] = layer
        for k, v in _export(layer).items():
            inp[f"{route}.p.{k}"] = v
        cin = 2 * C if route == "conv1x1" else C
        x = rng.normal(size=(4, 5, 5, cin)).astype(np.float32)
        x[2:] += 3.0  # the halves' means differ
        inp[f"{route}.x"] = x
        inp[f"{route}.z"] = rng.normal(size=(4, 5, 5, C)).astype(np.float32)
        inp[f"{route}.lab"] = rng.integers(0, C, (4, 5, 5))
    paddle.seed(2)
    tiny = JTiny()
    for k, v in _export(tiny).items():
        inp[f"tiny.p.{k}"] = v
    inp["tiny.x"] = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
    inp["tiny.y"] = rng.integers(0, 10, 4)
    inp["rn50.x"] = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    inp["rn50.y"] = rng.integers(0, 10, 4)
    return inp, layers


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    d = tmp_path_factory.mktemp("sync_bn")
    np.savez(d / "inputs.npz", **inputs[0])
    return workers.run_world("resnet_dp", RANKS, d, timeout=60)


@pytest.fixture()
def mesh2():
    mesh = jtopo.build_mesh({"dp": 2}, devices=jax.devices()[:2])
    jdist.set_hybrid_communicate_group(jtopo.HybridCommunicateGroup(
        mesh=mesh))
    yield mesh
    jdist.set_hybrid_communicate_group(None)
    jdist.destroy_process_group()


def _pixel_ce(out, lab):
    logp = jax.nn.log_softmax(out.reshape(-1, C).astype(jnp.float32))
    return -jnp.mean(jnp.take_along_axis(
        logp, jnp.asarray(lab.reshape(-1, 1)), axis=1))


def _ref_route(inp, layer, route, mesh):
    """The reference's global-batch BN on the mesh: (loss, out, running
    statistics, d params, dx, dz) of the per-pixel cross-entropy."""
    apply_fn, params, bufs = jfunctionalize(layer)
    lab = inp[f"{route}.lab"]

    def shard(a):
        return jdist.shard_batch(paddle.to_tensor(a), mesh=mesh).data

    x, z = shard(inp[f"{route}.x"]), shard(inp[f"{route}.z"])
    has_z = route == "fused_add"

    def loss_fn(p, x, z):
        out, nb = apply_fn(p, bufs, None, x, *((z,) if has_z else ()))
        return _pixel_ce(out, lab), (out, nb)

    (loss, (out, nb)), (gp, gx, gz) = jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2), has_aux=True)(params, x, z)
    return dict(loss=float(loss), out=np.asarray(out), buffers=nb,
                grads=gp, dx=np.asarray(gx),
                dz=np.asarray(gz) if has_z else None)


def _per_shard(inp, layer, route, rows):
    """The same layer on each rank's rows alone."""
    apply_fn, params, bufs = jfunctionalize(layer)
    outs = []
    for lo, hi in rows:
        args = [jnp.asarray(inp[f"{route}.x"][lo:hi])]
        if route == "fused_add":
            args.append(jnp.asarray(inp[f"{route}.z"][lo:hi]))
        outs.append(np.asarray(apply_fn(params, bufs, None, *args)[0]))
    return np.concatenate(outs)


@pytest.mark.parametrize("split", sorted(workers.BN_SPLITS))
@pytest.mark.parametrize("route", workers.BN_ROUTES)
def test_route_takes_the_global_batch(world, inputs, mesh2, route, split):
    """(a)-(c): output, loss, running statistics, dx (and dz) and the
    reduced dgamma/dbeta (and conv weight) against the reference's global
    batch, on even and uneven shards; per-shard BN is far from it."""
    inp, layers = inputs
    ref = _ref_route(inp, layers[route], route, mesh2)
    got = [w[f"{route}.{split}"] for w in world]
    out = np.concatenate([g["out"] for g in got])
    _close(out, ref["out"], RTOL32, "out")
    shards = _per_shard(inp, layers[route], route,
                        workers.BN_SPLITS[split])
    assert np.abs(out - shards).max() > 0.5
    _close(np.concatenate([g["dx"] for g in got]), RANKS * ref["dx"],
           GRAD_REL, "dx")
    if ref["dz"] is not None:
        _close(np.concatenate([g["dz"] for g in got]), RANKS * ref["dz"],
               GRAD_REL, "dz")
    # every rank reports the global loss, the same bits on each
    assert got[0]["loss"] == got[1]["loss"]
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["loss"], ref["loss"], rtol=RTOL32,
                                   err_msg=f"rank {r}")
        for k, v in ref["buffers"].items():
            _close(g["buffers"][k], v, RTOL32, f"rank {r} buffer {k}")
        for k, v in ref["grads"].items():
            _close(g["grads"][k], v, GRAD_REL, f"rank {r} grad {k}")
        # one all-reduce a batch norm each way; the gradients' bucket, the
        # label count and the loss
        assert g["launches"] == {"bn_sync": 2, "all_reduce": 3}, g
        composed = g["composed"].get("fused_bn", 0)
        assert composed == (1 if route == "composed" else 0)


@pytest.fixture(scope="module")
def ref_tiny(inputs):
    """The reference's step, once for the module (on its own mesh)."""
    mesh = jtopo.build_mesh({"dp": 2}, devices=jax.devices()[:2])
    jdist.set_hybrid_communicate_group(jtopo.HybridCommunicateGroup(
        mesh=mesh))
    try:
        return _ref_tiny_step(inputs[0], mesh)
    finally:
        jdist.set_hybrid_communicate_group(None)
        jdist.destroy_process_group()


def _ref_tiny_step(inp, mesh):
    jm = JTiny()
    for k, p in jm.named_parameters():
        p.set_value(inp[f"tiny.p.{k}"])
    jst = JTrainStep(jdist.DataParallel(jm), JF.cross_entropy, jopt.Momentum(
        learning_rate=LR, momentum=0.9, parameters=jm.parameters()),
        fused_opt=False)
    x = jdist.shard_batch(paddle.to_tensor(inp["tiny.x"]), mesh=mesh)
    y = jdist.shard_batch(paddle.to_tensor(inp["tiny.y"].astype(np.int32)),
                          mesh=mesh)
    loss = float(np.asarray(jst(x, y).data))
    # the reference's DataParallel names its buffers under its own slot
    return loss, {k: np.asarray(v) for k, v in jst.params.items()}, \
        {k.removeprefix("_layers."): np.asarray(v)
         for k, v in jst.buffers.items()}


@pytest.mark.parametrize("how", ["eager", "step", "unused"])
def test_tiny_resnet_step_matches_reference(world, inputs, ref_tiny, how):
    """(d): one Momentum(0.1, 0.9) step of the tiny NHWC bottleneck ResNet,
    2 images a rank, through the eager DataParallel loop (also with a
    parameter the loss never reaches under find_unused_parameters=True)
    and through TrainStep(DataParallel), against the reference's
    TrainStep(DataParallel) on the mesh."""
    inp, _ = inputs
    want_loss, want_p, want_b = ref_tiny
    for r, w in enumerate(world):
        got = w[f"tiny.{how}"]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=RTOL32,
                                   err_msg=f"rank {r}")
        assert set(got["params"]) == set(want_p)
        for k, v in want_p.items():
            p0 = inp[f"tiny.p.{k}"]
            _close((p0 - got["params"][k]) / LR, (p0 - v) / LR,
                   STEP_GRAD_REL, f"rank {r} update {k}")
        for k, v in want_b.items():
            _close(got["buffers"][k], v, RTOL32, f"rank {r} buffer {k}")
    a, b = (w[f"tiny.{how}"] for w in world)
    assert a["loss"] == b["loss"]
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k])


def test_tiny_resnet_collectives_a_step(world):
    """The collectives of a step, by kind: two "bn_sync" for each of the
    11 batch norms (forward and backward), and the gradient buckets plus
    the label count and the loss; the 1x1 chains and fused BNs ran."""
    for w in world:
        for how in ("eager", "step"):
            got = w[f"tiny.{how}"]
            assert got["launches"] == {"bn_sync": 2 * 11,
                                       "all_reduce": got["buckets"] + 2}
        st = w["tiny.step"]["stats"]
        assert st["conv1x1_stats"]["plain"] == 6
        assert st["fused_bn_fwd"]["plain"] == 10
        assert st["fused_bn_bwd_dx"]["plain"] == 10


@pytest.mark.parametrize("tag", ["rn50.fused", "rn50.unfused"])
def test_resnet50_runs_every_route_under_the_group(world, tag):
    """resnet50(data_format="NHWC") under DataParallel: with its defaults
    the 49 fused BN(+add)+ReLU and the 32 fused 1x1 chains of a step, with
    fused_bn=False none; either way 2 x 53 batch-norm all-reduces, and
    the ranks end with the same running statistics and reduced
    gradients."""
    fused = tag == "rn50.fused"
    for w in world:
        got = w[tag]
        assert got["launches"]["bn_sync"] == 2 * 53
        st = got["stats"]
        for name in ("fused_bn_fwd", "fused_bn_bwd_reduce",
                     "fused_bn_bwd_dx"):
            assert st[name]["plain"] == (49 if fused else 0), name
        assert st["conv1x1_stats"]["plain"] == (32 if fused else 0)
    a, b = (w[tag] for w in world)
    assert a["loss"] == b["loss"]
    for k in a["buffers"]:
        np.testing.assert_array_equal(a["buffers"][k], b["buffers"][k])
    for k in a["grads"]:
        np.testing.assert_array_equal(a["grads"][k], b["grads"][k])


# --------------------------- a world of one rank ----------------------------


@pytest.fixture()
def world1():
    from paddle_tpu_torch import distributed as tdist
    tdist.init_parallel_env(device="cpu")
    yield tdist
    tdist.destroy_process_group()


def _fwd_bwd(layer, x, z, scope):
    from paddle_tpu_torch.distributed import collective as Cl
    x = x.clone().requires_grad_(True)
    args = [x]
    if z is not None:
        args.append(z.clone().requires_grad_(True))
    Cl.reset_launch_stats()
    with scope:
        out = layer(*args)
    w = torch.linspace(-1.0, 1.0, out.numel()).reshape(out.shape)
    (out.float() * w).sum().backward()
    res = [out.detach()] + [a.grad for a in args]
    res += [p.grad for p in layer.parameters()]
    res += [b.clone() for b in layer.buffers()]
    return res, Cl.launch_stats()


@pytest.mark.parametrize("route", [r for r in workers.BN_ROUTES
                                   if r != "composed"])
def test_world_of_one_is_the_local_path_bit_for_bit(world1, route):
    """The grouped forward and backward in a world of one rank give the
    local path's output, gradients and running statistics bit for bit,
    with one all-reduce each way."""
    from paddle_tpu_torch.distributed import collective as Cl
    from paddle_tpu_torch.distributed import parallel
    g = Cl._get_default_group()
    gen = torch.Generator().manual_seed(4)
    cin = 2 * C if route == "conv1x1" else C
    x = torch.randn(4, 5, 5, cin, generator=gen) + 1.5
    z = torch.randn(4, 5, 5, C, generator=gen) \
        if route == "fused_add" else None
    a, b = workers.bn_layer(route), workers.bn_layer(route)
    b.load_state_dict(a.state_dict())
    local, n_local = _fwd_bwd(a, x, z, parallel.bn_scope(None))
    grouped, n_grouped = _fwd_bwd(b, x, z, parallel.bn_scope(g))
    assert n_local == {} and n_grouped == {"bn_sync": 2}
    assert len(local) == len(grouped)
    for u, v in zip(local, grouped):
        assert torch.equal(u, v)


def test_only_training_statistics_synchronize(world1):
    """Eval mode and use_global_stats=True never synchronize, and the
    group is in force only inside a DataParallel's forward."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import collective as Cl
    bn = nn.BatchNorm2D(C, act="relu", data_format="NHWC", device="cpu")
    dp = world1.DataParallel(bn)
    dpg = world1.DataParallel(nn.BatchNorm2D(
        C, data_format="NHWC", use_global_stats=True, device="cpu"))
    x = torch.randn(2, 3, 3, C)
    Cl.reset_launch_stats()
    dp(x)
    assert Cl.launch_stats() == {"bn_sync": 1}
    Cl.reset_launch_stats()
    bn(x)  # outside the forward: this rank's batch
    dpg(x)
    bn.eval()
    with torch.no_grad():
        dp(x)
    assert Cl.launch_stats() == {}


def test_torch_batch_norm_is_refused_in_training(world1):
    """torch.nn's own batch norms would take this rank's statistics:
    DataParallel refuses one in training mode, at wrapping and at the
    forward, and accepts it in eval mode."""
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 3, 1),
                              torch.nn.BatchNorm2d(3))
    with pytest.raises(NotImplementedError, match="SyncBatchNorm"):
        world1.DataParallel(net)
    net.eval()
    dp = world1.DataParallel(net)
    dp(torch.randn(2, 3, 4, 4))
    net.train()
    with pytest.raises(NotImplementedError, match="global batch"):
        dp(torch.randn(2, 3, 4, 4))


def test_recompute_replays_under_the_forwards_group(world1):
    """A region recomputed in the backward takes the group's statistics
    again (its forward's group, put back for the replay): one all-reduce
    in the forward, one in the replay, one in the backward, and the
    gradients of the plain grouped step bit for bit."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import collective as Cl
    from paddle_tpu_torch.distributed.fleet import utils as fleet_utils

    class Wrap(nn.Layer):
        def __init__(self, remat):
            super().__init__("cpu")
            self.remat = remat
            self.bn = nn.BatchNorm2D(C, act="relu", data_format="NHWC",
                                     device="cpu")

        def forward(self, x):
            if self.remat:
                return fleet_utils.recompute(self.bn, x)
            return self.bn(x)

    x = torch.randn(2, 3, 3, C, generator=torch.Generator().manual_seed(5))
    res = {}
    for remat in (False, True):
        m = Wrap(remat)
        dp = world1.DataParallel(m)
        xr = x.clone().requires_grad_(True)
        Cl.reset_launch_stats()
        (dp(xr) * torch.arange(xr.numel()).reshape(xr.shape)).sum() \
            .backward()
        res[remat] = ([xr.grad] + [p.grad for p in m.parameters()],
                      Cl.launch_stats()["bn_sync"])
    assert res[False][1] == 2 and res[True][1] == 3
    for u, v in zip(res[False][0], res[True][0]):
        assert torch.equal(u, v)


def test_sync_batch_norm_takes_the_reference_slots():
    """SyncBatchNorm is a batch norm in the reference's slots; outside a
    group it normalizes by the local batch; convert_sync_batchnorm returns
    the layer."""
    import inspect
    from paddle_tpu_torch import nn
    want = list(inspect.signature(jnn.SyncBatchNorm).parameters)
    got = list(inspect.signature(nn.SyncBatchNorm).parameters)
    assert got[:len(want)] == want
    layer = nn.BatchNorm2D(3, device="cpu")
    assert nn.SyncBatchNorm.convert_sync_batchnorm(layer) is layer
    x = np.random.default_rng(6).normal(size=(2, 3, 4, 4)).astype(
        np.float32)
    ref = np.asarray(jnn.SyncBatchNorm(3)(paddle.to_tensor(x)).data)
    got = nn.SyncBatchNorm(3, device="cpu")(torch.from_numpy(x))
    _close(got.detach().numpy(), ref, RTOL32)
