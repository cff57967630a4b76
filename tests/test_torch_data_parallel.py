"""The port's data parallelism against the JAX package's.

The reference's ``DataParallel`` replicates the parameters over a ``dp``
mesh, ``shard_batch`` places the global batch across it, and the
backward's gradients are those of the global batch's loss. The port runs
one process a rank: one 2-rank gloo world (``tests/torch_dist_workers.py``,
started once for this module with a time limit of its own) feeds each
rank its rows (``shard_batch``) and reduces the gradients over the group,
eagerly (``loss.backward(); opt.step()``) and inside ``jit.TrainStep``.
Tolerances:
- the eager Linear classifier (SGD one step, AdamW three): losses and
  parameters rtol 1e-5, atol 1e-6 (fp32 sums over 16 rows in another
  split);
- ``TrainStep(DataParallel(GPT(GPTConfig.tiny())))`` for 2 AdamW steps
  against the reference's ``TrainStep`` on a 2-device ``dp`` mesh:
  losses atol 1e-4; the optimizer's slots, which hold the reduced
  gradients themselves, rtol 1e-3 (atol 1e-6 on the first moment, 1e-9
  on the second, 1e-6 on the rest; 3e-7 and 6e-10 seen); every
  parameter within 1e-4 + 2 * lr * steps, and all but 0.1 % of its live elements (sqrt of the
  second moment above 1e-6, as ``tests/test_torch_train.py`` marks them)
  within 1e-4: an Adam step moves an element by about lr whatever the
  size of its gradient, so an element whose gradient was rounding noise
  in one step (the key bias's always is) lands up to 2 * lr away;
- labels ignored unevenly over the ranks (one rank's rows mostly
  ``ignore_index``): the reference's loss is the global batch's mean, and
  the port's, eager and in TrainStep, must equal it (same tolerances),
  not the mean of the ranks' means (which differs here by more than 0.05).
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import topology as jtopo
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.gpt import GPT as JGPT
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.nn import functional as JF

import torch_dist_workers as workers

TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs():
    rng = np.random.default_rng(0)
    paddle.seed(7)
    net = jnn.Linear(16, 4)
    inp = dict(w=np.asarray(net.weight.numpy()), b=np.asarray(
        net.bias.numpy()),
        X=rng.standard_normal((32, 16)).astype(np.float32),
        Y=rng.integers(0, 4, 32).astype(np.int64))
    yu = rng.integers(0, 4, 32).astype(np.int64)
    yu[:14] = -100  # rank 0's 16 rows keep 2 labels, rank 1's all 16
    inp["Yu"] = yu
    paddle.seed(0)
    jm = JGPT(JConfig.tiny())
    for k, p in jm.named_parameters():
        inp["gpt." + k] = np.asarray(p.data)
    for s in range(2):
        inp[f"ids{s}"] = rng.integers(1, 1024, (4, 16)).astype(np.int64)
        inp[f"labels{s}"] = rng.integers(0, 1024, (4, 16)).astype(np.int64)
        lu = inp[f"labels{s}"].copy()
        lu[:2, 3:] = -100  # rank 0's rows: 6 of 32 labels left
        inp[f"labels_u{s}"] = lu
    return inp


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    np.savez(d / "inputs.npz", **inputs)
    return workers.run_world("dp", 2, d)


@pytest.fixture()
def mesh2():
    mesh = jtopo.build_mesh({"dp": 2}, devices=jax.devices()[:2])
    jdist.set_hybrid_communicate_group(jtopo.HybridCommunicateGroup(
        mesh=mesh))
    yield mesh
    jdist.set_hybrid_communicate_group(None)
    jdist.destroy_process_group()


def _ref_eager(inputs, mesh, make_opt, steps, labels_key):
    net = jnn.Linear(16, 4)
    net.weight.set_value(inputs["w"])
    net.bias.set_value(inputs["b"])
    dp = jdist.DataParallel(net)
    opt = make_opt(dp.parameters())
    xb = jdist.shard_batch(paddle.to_tensor(inputs["X"]), mesh=mesh)
    yb = jdist.shard_batch(paddle.to_tensor(
        inputs[labels_key].astype(np.int32)), mesh=mesh)
    losses = []
    for _ in range(steps):
        loss = JF.cross_entropy(dp(xb), yb)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, net.weight.numpy(), net.bias.numpy()


CASES = {
    "sgd": (lambda ps: jopt.SGD(learning_rate=0.1, parameters=ps), 1, "Y"),
    "adamw": (lambda ps: jopt.AdamW(learning_rate=0.01, parameters=ps,
                                    weight_decay=0.01), 3, "Y"),
    "uneven": (lambda ps: jopt.SGD(learning_rate=0.1, parameters=ps), 1,
               "Yu"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_eager_data_parallel_matches_reference(world, inputs, mesh2, case):
    make_opt, steps, key = CASES[case]
    want_losses, want_w, want_b = _ref_eager(inputs, mesh2, make_opt, steps,
                                             key)
    for r, out in enumerate(world):
        losses, w, b = out[case]
        # every rank reports the global batch's loss, as the reference
        np.testing.assert_allclose(losses, want_losses, err_msg=f"rank {r}",
                                   **TOL)
        np.testing.assert_allclose(w, want_w, err_msg=f"rank {r}", **TOL)
        np.testing.assert_allclose(b, want_b, err_msg=f"rank {r}", **TOL)


def test_uneven_ignore_index_is_the_global_mean(world, inputs):
    """The case where the mean of the ranks' means differs: the reference
    (and so the port) takes the global batch's mean."""
    x = paddle.to_tensor(inputs["X"])
    y = inputs["Yu"].astype(np.int32)
    logits = jnn.Linear(16, 4)
    logits.weight.set_value(inputs["w"])
    logits.bias.set_value(inputs["b"])
    out = logits(x)
    glob = float(JF.cross_entropy(out, paddle.to_tensor(y)))
    halves = [float(JF.cross_entropy(out[i * 16:(i + 1) * 16],
                                     paddle.to_tensor(y[i * 16:(i + 1) * 16])))
              for i in range(2)]
    assert abs(np.mean(halves) - glob) > 0.05
    for out in world:
        np.testing.assert_allclose(out["uneven"][0][0], glob, **TOL)


def test_wrapping_broadcasts_rank0_and_delegates(world, inputs):
    for out in world:
        np.testing.assert_array_equal(out["broadcast_weight"], inputs["w"])
        assert out["names"] == ["weight", "bias"]
        assert out["state_keys"] == ["bias", "weight"]
        assert out["delegates"]


def test_unused_parameter_fails_the_backward(world):
    for out in world:
        assert "find_unused_parameters=True" in out["unused"]


def _ref_train_step(inputs, mesh, labels_key):
    paddle.seed(0)
    jm = JGPT(JConfig.tiny())
    jst = JTrainStep(jdist.DataParallel(jm), JF.cross_entropy, jopt.AdamW(
        learning_rate=1e-3, parameters=jm.parameters(), weight_decay=0.01),
        fused_opt=False)
    losses = []
    for s in range(2):
        ids = jdist.shard_batch(paddle.to_tensor(
            inputs[f"ids{s}"].astype(np.int32)), mesh=mesh)
        lab = jdist.shard_batch(paddle.to_tensor(
            inputs[f"{labels_key}{s}"].astype(np.int32)), mesh=mesh)
        losses.append(float(jst(ids, lab).data))
    return jst, losses


@pytest.mark.parametrize("tag,labels_key", [("step", "labels"),
                                            ("step_uneven", "labels_u")])
def test_train_step_over_data_parallel_matches_reference(
        world, inputs, mesh2, tag, labels_key):
    jst, want = _ref_train_step(inputs, mesh2, labels_key)
    assert np.all(np.isfinite(want)) and want[1] < want[0]
    flip = 2 * 1e-3 * 2
    for r, out in enumerate(world):
        got = out[tag]
        np.testing.assert_allclose(got["losses"], want, atol=1e-4,
                                   err_msg=f"rank {r}")
        # the gradient buckets (one at tiny widths), the label count and
        # the loss: all-reduced inside every step
        assert got["launches"] == {"all_reduce": 2 * 3}
        for k, v in jst.params.items():
            p, q = np.asarray(v), got["params"][k]
            np.testing.assert_allclose(q, p, atol=1e-4 + flip, rtol=0,
                                       err_msg=k)
            live = np.sqrt(np.asarray(jst.opt_state[k]["moment2"])) > 1e-6
            assert np.mean(np.abs(q - p)[live] > 1e-4) < 1e-3, k
            for s, sv in jst.opt_state[k].items():
                atol = {"moment1": 1e-6, "moment2": 1e-9}.get(s, 1e-6)
                np.testing.assert_allclose(got["slots"][k][s],
                                           np.asarray(sv), rtol=1e-3,
                                           atol=atol, err_msg=f"{k}.{s}")


def test_reference_batch_norm_under_data_parallel_is_global(mesh2):
    """The finding the port's synchronized batch norm follows
    (``tests/test_torch_sync_bn.py``): the reference's
    DataParallel(BatchNorm2D) on a dp-sharded batch normalizes by the
    statistics of the global batch, not of each shard."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 3, 5, 5)).astype(np.float32)
    x[2:] += 3.0  # the shards' means differ
    bn = jnn.BatchNorm2D(3)
    dp = jdist.DataParallel(bn)
    got = dp(jdist.shard_batch(paddle.to_tensor(x), mesh=mesh2)).numpy()
    whole = jnn.BatchNorm2D(3)(paddle.to_tensor(x)).numpy()
    per_shard = np.concatenate([jnn.BatchNorm2D(3)(paddle.to_tensor(
        x[i:i + 2])).numpy() for i in (0, 2)])
    np.testing.assert_allclose(got, whole, rtol=1e-5, atol=1e-5)
    assert np.abs(got - per_shard).max() > 0.5


def test_train_step_refuses_gloo_on_a_card():
    """A captured step cannot hold a gloo collective: a grouped TrainStep
    on a card over a gloo group raises, naming the backend."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.distributed import collective as C
    for backend in ("gloo", "nccl"):
        g = C.Group(None, ("world",), ranks=[0], pg=object(),
                    backend=backend)
        jit._require_capturable(g, torch.device("cpu"))
        if backend == "gloo":
            with pytest.raises(RuntimeError, match="gloo"):
                jit._require_capturable(g, torch.device("cuda"))
        else:
            jit._require_capturable(g, torch.device("cuda"))


def test_group_loss_value_is_the_same_bits_on_every_rank(monkeypatch):
    """The eager loss each rank reports is the group's value itself, not
    this rank's share plus (value - share), which rounds differently on
    each rank; its gradient is still the share's. The other rank's share
    stands in as what the all-reduce adds."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import parallel
    g = C.Group(None, ("world",), ranks=[0, 1], pg=object(),
                backend="gloo")
    other = torch.tensor(-0.8)
    monkeypatch.setattr(C, "raw_all_reduce",
                        lambda t, grp, op=None, kind=None: t.add_(other))
    local = torch.tensor(0.5, requires_grad=True)  # share 2 * 0.5 = 1.0
    out = parallel.group_loss(local, None, (g, True))
    want = (torch.tensor(1.0) + other) / 2
    assert torch.equal(out.detach(), want)
    out.backward()
    assert float(local.grad) == 2.0
