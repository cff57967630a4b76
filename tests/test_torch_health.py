"""The port's training-health plane (paddle_tpu_torch.profiler.health, the
TrainStep sentinel, the per-op NaN check under FLAGS_check_nan_inf, and
GradScaler's metrics) against the JAX package, on the CPU at
GPTConfig.tiny().

The same numpy weights and batches go to both packages. Tolerances:
- group names, bad-parameter groups and attributions: identical;
- decoded sentinel stats from the same tensors: 1e-6 relative (the port
  sums squares in float64, the reference in float32);
- decoded stats over 3 TrainStep steps of each package: 1e-5 relative.
  Those steps use Momentum: AdamW divides by sqrt(v) + eps, so an
  element whose gradient is rounding noise moves by up to lr in either
  package, and the update norm then differs by about 1e-5 between them
  for reasons of the optimizer, not of the sentinel (the direct test
  above it uses AdamW's tensors).

Deliberate differences, each pinned by a test here:
- the port replays a tripped step on the parameters it took in; the
  reference replays after its update, when the NaN has reached every
  parameter and the first bad op is the embedding;
- the port's vector holds norms reduced in float64, so a finite
  parameter whose square overflows float32 does not trip it.
"""
import re

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.gpt import GPT as JGPT
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.nn import functional as JF
from paddle_tpu.profiler import health as jhealth
from paddle_tpu_torch import amp, jit, nn, optimizer, set_flags
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.profiler import events, health, metrics
from paddle_tpu_torch.utils.convert import load_numpy_params


@pytest.fixture(autouse=True)
def _clean_health_state():
    health.reset()
    jhealth.reset()
    yield
    health.reset()
    jhealth.reset()


def _models(cfg=None):
    """The reference's tiny GPT (seed 0) and the port's, with its weights."""
    paddle.seed(0)
    jm = JGPT(cfg or JConfig.tiny())
    params = {k: np.asarray(p.data) for k, p in jm.named_parameters()}
    tm = GPT(GPTConfig(**vars(cfg or JConfig.tiny())), device="cpu")
    load_numpy_params(tm, params)
    return jm, tm


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1024, (2, 32))
    labels = rng.integers(0, 1024, (2, 32))
    return ((paddle.to_tensor(ids.astype(np.int32)),
             paddle.to_tensor(labels.astype(np.int32))),
            (torch.from_numpy(ids), torch.from_numpy(labels)))


def _steps(opt="momentum"):
    jm, tm = _models()
    if opt == "momentum":
        jo = jopt.Momentum(1e-2, 0.9, parameters=jm.parameters())
        to = optimizer.Momentum(1e-2, 0.9, parameters=tm.parameters())
    else:
        jo = jopt.AdamW(1e-3, parameters=jm.parameters(), weight_decay=0.01)
        to = optimizer.AdamW(1e-3, parameters=tm.parameters(),
                             weight_decay=0.01)
    js = JTrainStep(jm, JF.cross_entropy, jo, health=True)
    ts = jit.TrainStep(tm, F.cross_entropy, to, health=True)
    return jm, tm, js, ts


def _close(a, b, rtol):
    assert abs(a - b) <= rtol * abs(a), (a, b)


def _same_stats(want, got, rtol):
    for k in ("loss", "grad_norm", "param_norm", "update_ratio"):
        _close(want[k], got[k], rtol)
    assert want["group_grad_norms"].keys() == got["group_grad_norms"].keys()
    for g, v in want["group_grad_norms"].items():
        _close(v, got["group_grad_norms"][g], rtol)
    assert want["nonfinite"] == got["nonfinite"]
    assert want["bad_param_groups"] == got["bad_param_groups"]


# ------------------------------ tier 1 ---------------------------------------


@pytest.mark.parametrize("cap", [32, 3])
def test_group_names_match_the_reference(cap):
    jm, tm = _models()
    jp = {k: p.data for k, p in jm.named_parameters()}
    tp = dict(tm.named_parameters())
    want = jhealth.HealthProbe(jp, max_groups_=cap)
    got = health.HealthProbe(tp, max_groups_=cap)
    assert got.group_names == want.group_names
    assert got._group_of == want._group_of
    if cap == 3:
        assert got.group_names == ["bucket00", "bucket01", "bucket02"]


def test_stats_of_the_same_tensors_match_the_reference():
    """One AdamW step's loss, gradients and parameters from the reference,
    decoded by each package's probe."""
    jm, _, js, _ = _steps("adamw")
    (jx, jy), _ = _batch(0)
    old = {k: np.array(v) for k, v in js.params.items()}
    js(jx, jy)
    new = {k: np.array(v) for k, v in js.params.items()}
    rng = np.random.default_rng(1)
    grads = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in old.items()}
    loss = np.float32(6.5)
    want = js._health_probe.decode(js._health_probe.stats_vec(
        jnp.asarray(loss), {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in old.items()},
        {k: jnp.asarray(v) for k, v in new.items()}))
    t = {k: torch.from_numpy(v) for k, v in old.items()}
    probe = health.HealthProbe(t)
    got = probe.decode(probe.stats_vec(
        torch.tensor(loss), {k: torch.from_numpy(v) for k, v in
                             grads.items()}, t,
        {k: torch.from_numpy(v) for k, v in new.items()}))
    _same_stats(want, got, 1e-6)


def test_train_step_stats_match_the_reference_over_three_steps():
    _, _, js, ts = _steps()
    for s in range(3):
        (jx, jy), (tx, ty) = _batch(s)
        jl = js(jx, jy)
        tl = ts(tx, ty)
        _same_stats(js.last_health, ts.last_health, 1e-5)
        assert ts.last_health["step"] == s + 1
        # the sentinel's loss is the step's, bit for bit
        assert ts.last_health["loss"] == float(tl)
        _close(float(jl), float(tl), 1e-5)
    assert not health.tripped()
    assert metrics.default_registry().get("health_grad_norm").value() == \
        ts.last_health["grad_norm"]


def test_sentinel_matches_direct_readings():
    """grad_norm against torch.linalg.vector_norm of the gradients the
    step formed, update_ratio against ||new - old|| / ||old|| read around
    the step (the quantities the card check compares)."""
    _, tm, _, ts = _steps("adamw")
    (_, _), (tx, ty) = _batch(0)
    old = {k: p.detach().clone() for k, p in ts.params.items()}
    out = torch.func.functional_call(tm, ts.params, (tx,))
    g = torch.autograd.grad(F.cross_entropy(out, ty), list(ts.params.values()))
    ts(tx, ty)
    gn = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(x) for x in g]))
    num = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(ts.params[k].detach() - old[k])
         for k in old]))
    den = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(v) for v in old.values()]))
    _close(float(gn), ts.last_health["grad_norm"], 1e-5)
    _close(float(num / den), ts.last_health["update_ratio"], 1e-5)


def test_fetched_steps_train_bit_for_bit_as_unfetched_ones():
    """The sentinel changes nothing in training: a step with it on equals
    one with it off, bit for bit, loss, parameters and slots, with the
    grouped update and without."""
    for fused in (True, False):
        steps = []
        for on in (False, True):
            _, tm = _models()
            opt = optimizer.AdamW(1e-3, parameters=tm.parameters(),
                                  weight_decay=0.01)
            steps.append(jit.TrainStep(tm, F.cross_entropy, opt, health=on,
                                       fused_opt=fused))
        for s in range(3):
            losses = [float(st(*_batch(s)[1])) for st in steps]
            assert losses[0] == losses[1]
        off, on = steps
        for k, v in off.params.items():
            assert torch.equal(on.params[k], v) and on.params[k].requires_grad
            for slot, sv in off.opt_state[k].items():
                assert torch.equal(on.opt_state[k][slot], sv), (k, slot)


def test_the_fetch_is_decoded_later_without_a_wait():
    """A step leaves its vector pending with a snapshot of the masters it
    took in (two snapshots, used in turn), and updates the masters
    themselves in place; the next step decodes it at its start, and
    reading last_health decodes the newest."""
    _, _, _, ts = _steps()
    masters = dict(ts.params)
    ts(*_batch(0)[1])
    assert ts._pending is not None and health.last_stats() is None
    first = ts._pending[3]
    took = {k: v.detach().clone() for k, v in ts.params.items()}
    ts(*_batch(1)[1])
    assert health.last_stats()["step"] == 1
    assert ts._pending[0] == 2 and ts._pending[3] is not first
    assert all(torch.equal(ts._pending[3][k], v) for k, v in took.items())
    assert all(ts.params[k] is p for k, p in masters.items())
    assert not all(torch.equal(ts.params[k], v) for k, v in took.items())
    assert ts.last_health["step"] == 2 and ts._pending is None
    assert health.last_stats()["step"] == 2


def test_interval_bounds_the_fetches(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_HEALTH_INTERVAL", "2")
    _, _, _, ts = _steps()
    for s in range(3):
        ts(*_batch(s)[1])
    assert ts.last_health["step"] == 2


def test_health_none_follows_env_and_flag(monkeypatch):
    _, tm = _models()
    opt = optimizer.Momentum(1e-2, 0.9, parameters=tm.parameters())
    assert jit.TrainStep(tm, F.cross_entropy, opt)._health_probe is None
    monkeypatch.setenv("PADDLE_TPU_HEALTH", "1")
    assert jit.TrainStep(tm, F.cross_entropy, opt)._health_probe is not None
    monkeypatch.delenv("PADDLE_TPU_HEALTH")
    set_flags({"FLAGS_check_nan_inf": True})
    try:
        assert health.enabled()
        ts = jit.TrainStep(tm, F.cross_entropy, opt)
        assert ts._health_probe is not None
        # the per-op check never looks inside the step itself
        ts(*_batch(0)[1])
    finally:
        set_flags({"FLAGS_check_nan_inf": False})
    assert not health.enabled()


def _aten_calls(fn):
    calls = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            calls.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return calls


def test_sentinel_op_count_does_not_grow_with_depth():
    counts = []
    for layers in (2, 4):
        cfg = GPTConfig(**{**vars(GPTConfig.tiny()), "num_layers": layers})
        tm = GPT(cfg, device="cpu")
        p = {k: v.detach() for k, v in tm.named_parameters()}
        g = {k: torch.ones_like(v) for k, v in p.items()}
        new = {k: v + 1e-3 for k, v in p.items()}
        probe = health.HealthProbe(p)
        probe.stats_vec(torch.tensor(1.0), g, p, new)  # builds the index
        counts.append(_aten_calls(
            lambda: probe.stats_vec(torch.tensor(1.0), g, p, new)))
    assert len(counts[0]) == len(counts[1]) < 40
    assert counts[0] == counts[1]


# ----------------------------- NaN parameter ---------------------------------


def _poison(store, name, value=float("nan")):
    """Set element 0 of parameter `name` in a {name: tensor/array} dict."""
    v = store[name]
    if isinstance(v, torch.Tensor):
        with torch.no_grad():
            v.view(-1)[0] = value
    else:
        store[name] = v.reshape(-1).at[0].set(value).reshape(v.shape)


def test_nan_parameter_trips_both_packages_alike():
    jm, tm, js, ts = _steps()
    (jx, jy), (tx, ty) = _batch(0)
    js(jx, jy)
    ts(tx, ty)
    events.default_event_log().clear()
    name = "blocks.1.ln1.weight"
    _poison(js.params, name)
    _poison(ts.params, name)
    js(jx, jy)
    ts(tx, ty)
    assert js.last_health["nonfinite"] and ts.last_health["nonfinite"]
    assert ts.last_health["bad_param_groups"] == \
        js.last_health["bad_param_groups"] == ["blocks.1"]
    assert health.tripped()
    trip = [e for e in events.recent(20, kind="tensor_health")
            if e.get("src") == "sentinel"]
    assert len(trip) == 1 and trip[0]["bad_groups"] == ["blocks.1"]
    # the port replays the step on the parameters it took in: the first
    # bad op is the layer norm that reads the poisoned weight
    att = ts.last_attribution
    assert (att["op"], att["layer"], att["bad_kind"]) == \
        ("layer_norm", "blocks.1.ln1", "nan")
    # ... which is what either package's eager replay of the poisoned
    # model names (the reference's own step replays after its update,
    # when every parameter holds NaN, and names the embedding)
    assert js.last_attribution["layer"] == "wte"
    jm, tm = _models()
    jpar = dict(jm.named_parameters())[name]
    jpar.data = jpar.data.at[0].set(jnp.nan)
    with torch.no_grad():
        dict(tm.named_parameters())[name].view(-1)[0] = float("nan")
    want = jhealth.eager_replay(jm, JF.cross_entropy, [jx.data, jy.data])
    got = health.eager_replay(tm, F.cross_entropy, [tx, ty])
    for k in ("op", "layer", "output_index", "shape", "dtype", "bad_kind"):
        assert got[k] == want[k], k
    assert (got["op"], got["layer"]) == (att["op"], att["layer"])
    reg = metrics.default_registry()
    assert reg.get("health_nonfinite_total").value(src="sentinel") >= 1
    assert reg.get("health_nonfinite_total").value(src="eager") >= 1


def test_replay_runs_once_per_trip():
    _, _, _, ts = _steps()
    batch = _batch(0)[1]
    ts(*batch)
    events.default_event_log().clear()
    _poison(ts.params, "blocks.0.mlp.fc1.weight", float("inf"))
    ts(*batch)
    ts(*batch)
    ts.flush_health()
    ev = events.recent(50, kind="tensor_health")
    assert [e["src"] for e in ev].count("sentinel") == 1
    assert [e["src"] for e in ev].count("eager") == 1


def test_replay_counts_the_wrapper_not_its_plain_ops():
    """The attribution names the kernel wrapper even though the CPU runs
    its plain version's aten ops (the per-op check is suspended inside)."""
    _, tm = _models()
    with torch.no_grad():
        dict(tm.named_parameters())["ln_f.bias"].view(-1)[3] = float("nan")
    kernels.reset_stats()
    rec = health.eager_replay(tm, F.cross_entropy, list(_batch(0)[1]))
    assert (rec["op"], rec["layer"]) == ("layer_norm", "ln_f")
    assert kernels.all_stats()["layer_norm"]["plain"] == 5
    assert not health._ATTRIBUTION_ARMED


def test_finite_overflow_is_not_flagged():
    """A finite 1e20 parameter (a position row the batch never reads):
    its square overflows float32, which trips the reference's decode; the
    port's flags follow isfinite alone."""
    _, _, _, ts = _steps()
    with torch.no_grad():
        ts.params["wpe.weight"][100, 0] = 1e20
    ts(*_batch(0)[1])
    assert not ts.last_health["nonfinite"]
    assert ts.last_health["bad_param_groups"] == []
    assert np.isfinite(ts.last_health["param_norm"])
    assert ts.last_health["param_norm"] >= 1e20
    assert not health.tripped()


# ----------------------------- FLAGS_check_nan_inf ---------------------------


def _mask_op(msg):
    return re.sub(r"Operator '[^']*'", "Operator 'OP'", msg)


def test_set_flags_arms_the_per_op_check():
    set_flags({"FLAGS_check_nan_inf": True})
    paddle.set_flags({"FLAGS_check_nan_inf": True})
    try:
        events.default_event_log().clear()
        with pytest.raises(FloatingPointError) as got:
            torch.tensor([1.0]) / torch.tensor([0.0])
        with pytest.raises(FloatingPointError) as want:
            paddle.to_tensor(np.array([1.0], np.float32)) / \
                paddle.to_tensor(np.array([0.0], np.float32))
        assert _mask_op(str(got.value)) == _mask_op(str(want.value))
        assert str(got.value) == (
            "Operator 'div' output 0 contains inf (shape (1,), dtype "
            "float32). Enabled by FLAGS_check_nan_inf.")
        ev = events.recent(10, kind="tensor_health")[-1]
        assert (ev["src"], ev["op"], ev["bad_kind"]) == ("eager", "div",
                                                        "inf")
        # uninitialised memory is not an op output to check
        torch.empty(1000).fill_(1.0)
    finally:
        set_flags({"FLAGS_check_nan_inf": False})
        paddle.set_flags({"FLAGS_check_nan_inf": False})
    torch.tensor([1.0]) / torch.tensor([0.0])  # disarmed: no raise
    assert not health._ATTRIBUTION_ARMED


def test_per_op_check_names_the_layer_path():
    class MLP(nn.Layer):
        def __init__(self):
            super().__init__(device="cpu")
            self.fc1 = nn.Linear(8, 16, device="cpu")
            self.fc2 = nn.Linear(16, 4, device="cpu")

        def forward(self, x):
            return self.fc2(F.relu(self.fc1(x)))

    net = MLP()
    with torch.no_grad():
        net.fc2.weight[0, 0] = float("nan")
    health.index_model(net)
    set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match="in layer 'fc2'"):
            net(torch.ones(2, 8))
        assert events.recent(10, kind="tensor_health")[-1]["layer"] == "fc2"
    finally:
        set_flags({"FLAGS_check_nan_inf": False})


# ------------------------------ GradScaler -----------------------------------


def test_grad_scaler_metrics():
    reg = metrics.default_registry()
    found = reg.get("amp_found_inf_total")
    before = found.total()
    w = torch.nn.Parameter(torch.ones(3))
    opt = optimizer.SGD(0.1, parameters=[w])
    scaler = amp.GradScaler(init_loss_scaling=1024.0,
                            decr_every_n_nan_or_inf=1)
    assert reg.get("amp_loss_scale").value() == 1024.0
    scaler.scale((w * torch.tensor([1.0, float("inf"), 1.0])).sum()) \
        .backward()
    scaler.step(opt)
    assert found.total() == before + 1
    assert reg.get("amp_loss_scale").value() == 512.0
    assert torch.equal(w.detach(), torch.ones(3))  # the step was skipped
    opt.clear_grad()
    scaler.scale(w.sum()).backward()
    scaler.step(opt)
    assert found.total() == before + 1
