"""The port's ZeRO sharding against the JAX package's.

The reference's ``group_sharded_parallel`` places the optimizer's slots
(and at ``"p_g_os"`` the parameters) over the ``sharding`` axis of a mesh
and trains to the unsharded numbers. The port runs one process a rank:
gloo CPU worlds of 2 (here) and 4 (``test_torch_sharding_world4.py``),
each ``tests/torch_dist_workers.py zero`` started once for its module with
a time limit of its own, train at every level, and each rank is held
against the reference on a mesh of as many devices:

- the reference test's Net (d 16) with Adam on the same batch everywhere,
  4 steps: losses and parameters at the reference's own tolerance, rtol
  1e-4 and atol 1e-5;
- GPT tiny with AdamW, each rank on its rows of the global batch, 4 steps
  eagerly and (world 2) inside ``jit.TrainStep``, against the reference's
  unsharded ``TrainStep``, which its contract says sharding leaves as it is
  (``tests/test_recompute_sharding.py``; its eager GPT on a sharded mesh
  stalls in XLA's CPU collectives here), with each slot's dimension from
  the reference's own rule (``_with_sharding_axis``): losses at rtol 1e-4 and
  atol 1e-5; parameters as ``tests/test_torch_train.py`` holds AdamW runs
  of this model: each element the second moment shows live (its sqrt
  above 1e-6) at atol 1e-4, every element within 2 * lr * steps more (an
  Adam step moves an element whose gradient was rounding noise by up to
  lr whatever its size);
- on every rank each slot is shard r of the reference's slot along the
  dimension the reference's spec names (the same tolerances), and at
  stage 3 each parameter at rest is shard r of the reference's parameter;
- the health sentinel of ``jit.TrainStep`` over the sharded optimizer
  reads the whole arrays' norms: at world 2 within rtol 1e-3 of the
  reference's sentinel (gradients reduced in another order), at world 1
  equal to the plain step's;
- ``jit.TrainStep`` over a group-sharded model at world 1 is bit for bit
  with the plain ``TrainStep`` at every level.
"""
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import topology as jtopo
from paddle_tpu.distributed.meta_parallel.engine import _with_sharding_axis
from paddle_tpu.distributed.sharding import \
    group_sharded_parallel as jgroup_sharded
from paddle_tpu.models.gpt import GPT as JGPT
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.nn import functional as JF

import torch_dist_workers as workers

TOL = dict(rtol=1e-4, atol=1e-5)
LEVELS = workers.ZERO_LEVELS
STEPS = 4


class JNet(jnn.Layer):
    """The reference test's Net (``tests/test_recompute_sharding.py``)."""

    def __init__(self, d=16):
        super().__init__()
        self.fc1 = jnn.Linear(d, 32)
        self.fc2 = jnn.Linear(32, 32)
        self.fc3 = jnn.Linear(32, d)

    def forward(self, x):
        return self.fc3(JF.relu(self.fc2(JF.relu(self.fc1(x)))))


def _inputs():
    rs = np.random.RandomState(0)
    inp = dict(X=rs.randn(16, 16).astype(np.float32),
               Y=rs.randn(16, 16).astype(np.float32))
    paddle.seed(0)
    for k, p in JNet().named_parameters():
        inp["net." + k] = np.asarray(p.data)
    paddle.seed(0)
    for k, p in JGPT(JConfig.tiny()).named_parameters():
        inp["gpt." + k] = np.asarray(p.data)
    rng = np.random.default_rng(0)
    for s in range(STEPS):
        inp[f"ids{s}"] = rng.integers(1, 1024, (4, 16)).astype(np.int64)
        inp[f"labels{s}"] = rng.integers(0, 1024, (4, 16)).astype(np.int64)
    return inp


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _world(n, inputs, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"zero{n}")
    np.savez(d / "inputs.npz", **inputs)
    return d, workers.run_world("zero", n, d, timeout=240)


@pytest.fixture(scope="module")
def world2(inputs, tmp_path_factory):
    return _world(2, inputs, tmp_path_factory)


def _load(model, inputs, prefix):
    for k, p in model.named_parameters():
        p.set_value(inputs[prefix + k])


_REF = {}
_REF_HEALTH = {}  # the reference TrainStep's newest sentinel stats


def _ref_run(kind, level, n, inputs, step=False):
    """The reference's run: (losses, {name: param}, {name: {slot: array}},
    {name: sharded dim}, {name: {slot: sharded dim}}). Net: the
    group-sharded run on a mesh with a sharding axis of n devices. GPT:
    the unsharded TrainStep run (cached: neither the level, n nor the
    eager loop moves it past the stated tolerances), with the dimensions
    the reference's rule gives at axis size n."""
    # GPT: the reference's TrainStep gives its numbers for the eager loop
    # too (an eager JAX GPT compiles op by op: tens of seconds)
    key = (kind, level, n, step) if kind == "net" else (kind,)
    if key not in _REF:
        _REF[key] = _ref_numbers(kind, level, n, inputs,
                                 step or kind == "gpt")
    losses, params, slots, pdims, sdims = _REF[key]
    if kind == "gpt":
        pdims = {k: _rule_dim(v.shape, n) for k, v in params.items()}
        sdims = {k: {s: _rule_dim(v.shape, n) for s, v in d.items()}
                 for k, d in slots.items()}
    return losses, params, slots, pdims, sdims


def _ref_numbers(kind, level, n, inputs, step):
    if kind == "net":
        jdist.set_hybrid_communicate_group(
            jtopo.HybridCommunicateGroup(dims={"sharding": n}))
        net = JNet()
        _load(net, inputs, "net.")
        opt = jopt.Adam(learning_rate=1e-2, parameters=net.parameters())
        net, opt, _ = jgroup_sharded(net, opt, level)
    else:
        net = JGPT(JConfig.tiny())
        _load(net, inputs, "gpt.")
        opt = jopt.AdamW(learning_rate=1e-3, weight_decay=0.01,
                         parameters=net.parameters())
    try:
        losses = []
        if step:
            from paddle_tpu.jit import TrainStep
            ts = TrainStep(net, JF.cross_entropy, opt, health=True)
            for s in range(STEPS):
                losses.append(float(ts(
                    paddle.to_tensor(inputs[f"ids{s}"].astype(np.int32)),
                    paddle.to_tensor(inputs[f"labels{s}"].astype(
                        np.int32)))))
            params = {k: np.asarray(v) for k, v in ts.params.items()}
            slots = {k: {s: np.asarray(v) for s, v in d.items()}
                     for k, d in ts.opt_state.items()}
            _REF_HEALTH[kind] = dict(ts.last_health)
            return losses, params, slots, None, None
        for s in range(STEPS):
            if kind == "net":
                out = net(paddle.to_tensor(inputs["X"]))
                loss = JF.mse_loss(out, paddle.to_tensor(inputs["Y"]))
            else:
                loss = JF.cross_entropy(
                    net(paddle.to_tensor(inputs[f"ids{s}"].astype(
                        np.int32))),
                    paddle.to_tensor(inputs[f"labels{s}"].astype(np.int32)))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        names = {id(p): k for k, p in net.named_parameters()}
        inner = getattr(opt, "_opt", opt)
        params = {k: np.asarray(p.data) for k, p in net.named_parameters()}
        slots = {names[pid]: {s: np.asarray(v) for s, v in d.items()}
                 for pid, d in inner._slots.items()}
        pdims = {k: _spec_dim(p.data) for k, p in net.named_parameters()}
        sdims = {names[pid]: {s: _spec_dim(v) for s, v in d.items()}
                 for pid, d in inner._slots.items()}
        return losses, params, slots, pdims, sdims
    finally:
        jdist.set_hybrid_communicate_group(None)


def _spec_dim(arr):
    """The dimension a reference array is sharded along over the
    ``sharding`` axis, or None."""
    spec = getattr(getattr(arr, "sharding", None), "spec", None) or ()
    for i, p in enumerate(spec):
        if p == "sharding" or (isinstance(p, tuple) and "sharding" in p):
            return i
    return None


def _rule_dim(shape, n):
    """The dimension the reference's rule shards an array of ``shape``
    along at axis size n (``_with_sharding_axis``), or None."""
    spec = _with_sharding_axis(P(), "sharding", tuple(shape),
                               {"sharding": n})
    for i, p in enumerate(spec):
        if p == "sharding":
            return i
    return None


def _shard(a, dim, r, n):
    if dim is None:
        return a
    k = a.shape[dim] // n
    return np.take(a, np.arange(r * k, (r + 1) * k), axis=dim)


def _hold_params(got, want, kind, slots, lr, err):
    for k, w in want.items():
        g = got[k]
        if kind == "net":
            np.testing.assert_allclose(g, w, err_msg=f"{err} {k}", **TOL)
            continue
        live = np.sqrt(slots[k]["moment2"]) > 1e-6
        np.testing.assert_allclose(g[live], w[live], atol=1e-4, rtol=0,
                                   err_msg=f"{err} {k} (live)")
        np.testing.assert_allclose(g, w, atol=1e-4 + 2 * lr * STEPS, rtol=0,
                                   err_msg=f"{err} {k}")


def _hold_world(world, kind, level, inputs, key=None):
    n = len(world)
    losses, params, slots, pdims, sdims = _ref_run(
        kind, level, n, inputs, step=key == "step")
    lr = 1e-2 if kind == "net" else 1e-3
    for out in world:
        r = out["rank"]
        got = out[(key or kind, level)]
        err = f"{kind} {level} world {n} rank {r}"
        np.testing.assert_allclose(got["losses"], losses, err_msg=err, **TOL)
        _hold_params(got["params"], params, kind, slots, lr, err)
        for k, d in slots.items():
            for s, want in d.items():
                dim = sdims[k][s]
                # the port's layout cuts where the reference's spec does
                assert got["dims"][k] == dim, (err, k, s)
                want_r = _shard(want, dim, r, n)
                g = got["slots"][k][s]
                assert g.shape == want_r.shape, (err, k, s)
                if kind == "net":
                    np.testing.assert_allclose(g, want_r, err_msg=err, **TOL)
                else:  # the moments hold the reduced gradients themselves
                    np.testing.assert_allclose(
                        g, want_r, rtol=1e-3,
                        atol=1e-6 if s == "moment1" else 1e-9,
                        err_msg=f"{err} {k}.{s}")
        if level == "p_g_os" and key != "step":
            for k, w in params.items():
                assert got["dims"][k] == pdims[k], (err, k)
                want_r = _shard(w, pdims[k], r, n)
                assert got["shards"][k].shape == want_r.shape, (err, k)
                if kind == "net":
                    np.testing.assert_allclose(got["shards"][k], want_r,
                                               err_msg=err, **TOL)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("kind", ["net", "gpt"])
def test_world2_matches_reference(world2, inputs, kind, level):
    _hold_world(world2[1], kind, level, inputs)


@pytest.mark.parametrize("level", LEVELS)
def test_train_step_world2_matches_reference(world2, inputs, level):
    _hold_world(world2[1], "gpt", level, inputs, key="step")
    for out in world2[1]:
        rec = out[("step", level)]
        # one reduce-scatter and one all-gather a bucket, bucketed (GPT
        # tiny fills one bucket); the label count and the loss all-reduced
        assert rec["launches"] == {"reduce_scatter": STEPS,
                                   "all_gather": STEPS,
                                   "all_reduce": 2 * STEPS,
                                   "health": 2 * STEPS}, rec["launches"]
        # the sentinel reads the whole arrays' norms (the shards' squared
        # sums over the group), as the reference's does
        want, got = _REF_HEALTH["gpt"], rec["health"]
        for k in ("loss", "grad_norm", "param_norm", "update_ratio"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                       err_msg=k)
        assert got["group_grad_norms"].keys() == \
            want["group_grad_norms"].keys()
        for g, v in want["group_grad_norms"].items():
            np.testing.assert_allclose(got["group_grad_norms"][g], v,
                                       rtol=1e-3, err_msg=g)
        assert got["nonfinite"] is False and got["bad_param_groups"] == []
        # state_dict gathers the slots whole
        shapes = {tuple(v.shape) for v in rec["params"].values()}
        assert all(tuple(s) in shapes for s in rec["state_dict_slots"])


def test_slots_and_stage3_parameters_are_halved(world2):
    for out in world2[1]:
        for level in LEVELS:
            rec = out[("gpt", level)]
            whole = sum(v.size for v in rec["params"].values())
            held = sum(v["moment1"].size for v in rec["slots"].values())
            assert held * 2 == whole, (level, held, whole)
            at_rest = sum(v.size for v in rec["shards"].values())
            assert at_rest * (2 if level == "p_g_os" else 1) == whole


def test_saved_model_loads_in_the_reference(world2, inputs):
    d = world2[0] / "saved"
    params = paddle.load(str(d / "model.pdparams"))
    opt = paddle.load(str(d / "model.pdopt"))
    out = world2[1][0][("net", "p_g_os")]
    for k, v in out["params"].items():
        np.testing.assert_array_equal(np.asarray(params[k]), v)
    slots = _ref_run("net", "p_g_os", 2, inputs)[2]
    for k, d in slots.items():
        for s, want in d.items():
            np.testing.assert_allclose(np.asarray(opt[f"{k}.{s}"]), want,
                                       err_msg=f"{k}.{s}", **TOL)


def test_raises_as_the_reference(world2):
    errs = world2[1][0]["errors"]
    assert errs["level"] == "ValueError"
    assert errs["offload"] == "NotImplementedError"
    assert errs["buffer"] == "NotImplementedError"
    assert errs["kwargs"] == "NotImplementedError"
    assert "sharding" in errs["no_axis"]
    net = JNet()
    with pytest.raises(ValueError):
        jgroup_sharded(net, jopt.Adam(parameters=net.parameters()), "zero")


# ---------------------------------------------------------------------------
# a world of one: TrainStep over the sharded model is the plain step
# ---------------------------------------------------------------------------
@pytest.fixture()
def world1():
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import topology
    dist.init_parallel_env(device="cpu")
    yield
    topology.set_hybrid_communicate_group(None)
    dist.destroy_process_group()


def test_world1_topology_without_the_axis_raises(world1, inputs):
    """A user's topology with no ``sharding`` axis is refused at any world
    size, as the reference refuses it, and never replaced; one with the
    axis (of size 1 here) gives its group."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel

    def wrap():
        model = workers.zero_gpt(inputs)
        return group_sharded_parallel(model, optimizer.AdamW(
            parameters=model.parameters()), "os")

    user = topology.HybridCommunicateGroup(dims={"dp": 1})
    topology.set_hybrid_communicate_group(user)
    with pytest.raises(ValueError, match="sharding"):
        wrap()
    assert topology.get_hybrid_communicate_group() is user
    jdist.set_hybrid_communicate_group(
        jtopo.HybridCommunicateGroup(dims={"data": 8}))
    try:
        net = JNet()
        with pytest.raises(ValueError, match="sharding"):
            jgroup_sharded(net, jopt.Adam(parameters=net.parameters()), "os")
    finally:
        jdist.set_hybrid_communicate_group(None)
    topology.set_hybrid_communicate_group(
        topology.HybridCommunicateGroup(dims={"sharding": 1}))
    _, opt, _ = wrap()
    assert opt.group.nranks == 1


@pytest.mark.parametrize("amp", [None, torch.bfloat16])
def test_train_step_world1_bit_for_bit(world1, inputs, amp):
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.nn import functional as F

    def run(level):
        topology.set_hybrid_communicate_group(None)
        model = workers.zero_gpt(inputs)
        opt = optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                              parameters=model.parameters())
        if level is not None:
            model, opt, _ = group_sharded_parallel(model, opt, level)
        step = jit.TrainStep(model, F.cross_entropy, opt, amp_dtype=amp)
        losses = [step(torch.from_numpy(inputs[f"ids{s}"]),
                       torch.from_numpy(inputs[f"labels{s}"]))
                  for s in range(3)]
        return torch.stack(losses), step

    want, plain = run(None)
    for level in LEVELS:
        got, step = run(level)
        assert torch.equal(got, want), level
        for k, v in plain.params.items():
            assert torch.equal(step.params[k], v), (level, k)
            for s, sv in plain.opt_state[k].items():
                assert torch.equal(step.opt_state[k][s], sv), (level, k, s)
        assert all(np.array_equal(a, b) for a, b in zip(
            step.state_dict()["opt_flat"], plain.state_dict()["opt_flat"]))


def test_eager_world1_bit_for_bit(world1, inputs):
    """The eager loop over the group-sharded model at world 1 equals the
    plain eager loop bit for bit at every level: losses, parameters
    (``state_dict``) and the optimizer's state (``state_dict``)."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.nn import functional as F

    def run(level):
        topology.set_hybrid_communicate_group(None)
        model = workers.zero_gpt(inputs)
        opt = optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                              parameters=model.parameters())
        if level is not None:
            model, opt, _ = group_sharded_parallel(model, opt, level)
        losses = []
        for s in range(3):
            loss = F.cross_entropy(model(torch.from_numpy(
                inputs[f"ids{s}"])), torch.from_numpy(inputs[f"labels{s}"]))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.detach())
        return torch.stack(losses), model.state_dict(), opt.state_dict()

    want = run(None)
    for level in LEVELS:
        got = run(level)
        assert torch.equal(got[0], want[0]), level
        for k, v in want[1].items():
            assert torch.equal(got[1][k], v), (level, k)
        assert set(got[2]) == set(want[2])
        for k, v in want[2].items():
            assert torch.equal(torch.as_tensor(got[2][k]),
                               torch.as_tensor(v)), (level, k)


def test_gloo_card_route_world1(world1, inputs, monkeypatch):
    """Under gloo a card's tensors go only through all_reduce and broadcast:
    there the reduce-scatter is an all-reduce and a slice, the all-gather a
    broadcast from each owner, each counted under its own name. Driven here
    on the CPU's tensors (the route forced), bit for bit with the plain
    step at world 1."""
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.distributed.sharding import (
        ZeroLayout, group_sharded_parallel)
    from paddle_tpu_torch.nn import functional as F
    monkeypatch.setattr(ZeroLayout, "_gloo_card", lambda self, t: True)

    def run(level):
        topology.set_hybrid_communicate_group(None)
        model = workers.zero_gpt(inputs)
        opt = optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                              parameters=model.parameters())
        if level is not None:
            model, opt, _ = group_sharded_parallel(model, opt, level)
        step = jit.TrainStep(model, F.cross_entropy, opt)
        C.reset_launch_stats()
        losses = torch.stack([step(torch.from_numpy(inputs[f"ids{s}"]),
                                   torch.from_numpy(inputs[f"labels{s}"]))
                              for s in range(2)])
        return losses, step, C.launch_stats()

    want, plain, _ = run(None)
    for level in LEVELS:
        got, step, launches = run(level)
        assert torch.equal(got, want), level
        for k, v in plain.params.items():
            assert torch.equal(step.params[k], v), (level, k)
        assert launches == {"reduce_scatter_as_all_reduce": 2,
                            "all_gather_as_broadcast": 2,
                            "all_reduce": 4}, launches


def test_health_sentinel_world1_and_trip(world1, inputs, monkeypatch):
    """At world 1 the sharded step's sentinel reads what the plain step's
    does at every level; a NaN in a parameter trips it and the replay,
    on this rank alone, names the same layer."""
    from paddle_tpu_torch import jit, optimizer
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.nn import functional as F
    monkeypatch.setenv("PADDLE_TPU_HEALTH_INTERVAL", "1")
    batch = (torch.from_numpy(inputs["ids0"]),
             torch.from_numpy(inputs["labels0"]))

    def run(level):
        topology.set_hybrid_communicate_group(None)
        model = workers.zero_gpt(inputs)
        opt = optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                              parameters=model.parameters())
        if level is not None:
            model, opt, _ = group_sharded_parallel(model, opt, level)
        step = jit.TrainStep(model, F.cross_entropy, opt, health=True)
        step(*batch)
        clean = dict(step.last_health)
        with torch.no_grad():
            k = "blocks.1.ln1.weight"
            step.params[k].view(-1)[0] = float("nan")
        step(*batch)
        return clean, dict(step.last_health), step.last_attribution

    want = run(None)
    for level in LEVELS:
        got = run(level)
        for k in ("loss", "grad_norm", "param_norm", "update_ratio",
                  "group_grad_norms"):
            assert got[0][k] == want[0][k], (level, k)
        assert got[1]["nonfinite"] and got[1]["bad_param_groups"] == \
            want[1]["bad_param_groups"] == ["blocks.1"]
        assert got[2] is not None and got[2] == want[2], (level, got[2])
