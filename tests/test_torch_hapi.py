"""The port's hapi (paddle_tpu_torch.hapi.Model, its callbacks, io and
metric) and the health plane's rollback against the JAX package, on the
CPU at GPTConfig.tiny().

Both packages train the same numpy weights on the same per-index
dataset (shuffle off, so a resumed epoch replays the same batches).
Tolerances:
- the port's resumed run against its own uninterrupted run: bit for bit
  (the CPU's plain versions are deterministic), losses and every
  parameter;
- the port's run against the reference's (uninterrupted and resumed):
  losses within 1e-4 absolute, fp32 AdamW over 8 steps (the two
  packages' fp32 sums differ in order, as in test_torch_train.py);
- a rollback restores the checkpoint's tensors bit for bit, and both
  packages roll back to the same step.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import Model as JModel
from paddle_tpu import optimizer as jopt
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.io import Dataset as JDataset
from paddle_tpu.models.gpt import GPT as JGPT
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.nn import functional as JF
from paddle_tpu.profiler import events as jevents
from paddle_tpu.profiler import health as jhealth
from paddle_tpu.profiler import metrics as jmetrics
from paddle_tpu_torch import metric, optimizer
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.hapi import callbacks as cb
from paddle_tpu_torch.io import DataLoader, Dataset, TensorDataset
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.profiler import events, health, metrics
from paddle_tpu_torch.utils.convert import load_numpy_params

STEPS = 8  # 2 epochs of 4 batches of 2


@pytest.fixture(autouse=True)
def _clean_health_state():
    health.reset()
    jhealth.reset()
    yield
    health.reset()
    jhealth.reset()


def _sample(i):
    rng = np.random.default_rng(1000 + i)
    return (rng.integers(1, 1024, 16).astype(np.int64),
            rng.integers(0, 1024, 16).astype(np.int64))


class DS(Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        return _sample(i)


class JDS(JDataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        return tuple(a.astype(np.int32) for a in _sample(i))


def _weights():
    paddle.seed(0)
    jm = JGPT(JConfig.tiny())
    return jm, {k: np.asarray(p.data) for k, p in jm.named_parameters()}


def _port_model(weights=None, seed=0):
    torch.manual_seed(seed)
    net = GPT(GPTConfig.tiny(), device="cpu")
    if weights is not None:
        load_numpy_params(net, weights)
    m = Model(net)
    m.prepare(optimizer.AdamW(1e-3, parameters=net.parameters(),
                              weight_decay=0.01), F.cross_entropy)
    return m


def _ref_model():
    jm, _ = _weights()
    m = JModel(jm)
    m.prepare(jopt.AdamW(1e-3, parameters=jm.parameters(),
                         weight_decay=0.01), JF.cross_entropy)
    return m


class Losses:
    """Records each batch's loss (a Callback of either package)."""

    def __init__(self, base):
        self.base, self.losses = base, []

    def __getattr__(self, name):
        if name.startswith("on_") or name.startswith("set_"):
            return lambda *a, **k: None
        raise AttributeError(name)

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(logs["loss"][0])


class Crash(cb.Callback):
    """Stands for a killed job: raises after global step `at`."""

    def __init__(self, at):
        super().__init__()
        self.at, self.n = at, 0

    def on_train_batch_end(self, step, logs=None):
        self.n += 1
        if self.n == self.at:
            raise KeyboardInterrupt


def _state(m):
    m._sync_from_train_step()
    return {k: v.detach().clone() for k, v in m.network.state_dict().items()}


def _uninterrupted(weights):
    m = _port_model(weights)
    rec = Losses(None)
    m.fit(DS(), batch_size=2, epochs=2, shuffle=False, verbose=0,
          callbacks=[rec])
    return m, rec.losses


def test_resume_equals_the_uninterrupted_run_and_the_reference(tmp_path):
    _, weights = _weights()
    full, full_losses = _uninterrupted(weights)
    assert len(full_losses) == STEPS

    # interrupted after step 5; checkpoints at steps 2 and 4
    m = _port_model(weights)
    rec = Losses(None)
    with pytest.raises(KeyboardInterrupt):
        m.fit(DS(), batch_size=2, epochs=2, shuffle=False, verbose=0,
              callbacks=[cb.FaultTolerantCheckpoint(str(tmp_path),
                                                    save_freq_steps=2),
                         rec, Crash(5)])
    assert ckpt.CheckpointManager(str(tmp_path)).steps() == [4, 2]
    np.testing.assert_array_equal(rec.losses, full_losses[:5])

    # a fresh job from other weights resumes at step 4, bit for bit
    resumed = _port_model(seed=1)
    rec2 = Losses(None)
    resumed.fit(DS(), batch_size=2, epochs=2, shuffle=False, verbose=0,
                callbacks=[rec2], resume=str(tmp_path))
    np.testing.assert_array_equal(rec2.losses, full_losses[4:])
    want, got = _state(full), _state(resumed)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert resumed._train_step._t == STEPS

    # the reference: uninterrupted, and resumed from the port's step-4
    # file (the rng leaf is the port's: the reference's dropout-free
    # model never draws from it)
    ref = _ref_model()
    jrec = Losses(None)
    ref.fit(JDS(), batch_size=2, epochs=2, shuffle=False, verbose=0,
            callbacks=[jrec])
    np.testing.assert_allclose(full_losses, jrec.losses, atol=1e-4, rtol=0)
    blob = ckpt.load(str(tmp_path / "ckpt_4"))
    jres = _ref_model()
    jres.network.set_state_dict({k: jnp.asarray(v.numpy())
                                 for k, v in blob["network"].items()})
    jres._pending_ts_state = {"t": blob["train_step"]["t"], "opt_flat": [
        v.numpy() for v in blob["train_step"]["opt_flat"]]}
    jrec2 = Losses(None)
    for i in range(4, STEPS):
        x, y = JDS()[2 * (i % 4)], JDS()[2 * (i % 4) + 1]
        jrec2.losses += jres.train_batch(
            [np.stack([x[0], y[0]])], [np.stack([x[1], y[1]])])
    np.testing.assert_allclose(rec2.losses, jrec2.losses, atol=1e-4, rtol=0)


class Poison(cb.Callback):
    """Writes NaN into the step's masters after global step `at`."""

    def __init__(self, at, jax=False):
        super().__init__()
        self.at, self.jax, self.n = at, jax, 0

    def on_train_batch_end(self, step, logs=None):
        self.n += 1
        if self.n != self.at:
            return
        ts = self.model._train_step
        name = "blocks.1.ln1.weight"
        if self.jax:
            ts.params[name] = ts.params[name].at[0].set(jnp.nan)
        else:
            with torch.no_grad():
                ts.params[name][0] = float("nan")


def test_rollback_restores_the_same_step_in_both_packages(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_HEALTH", "1")
    _, weights = _weights()
    events.default_event_log().clear()
    reg = metrics.default_registry()
    rb0 = reg.get("health_rollback_total").total()
    m = _port_model(weights)
    ftc = cb.FaultTolerantCheckpoint(str(tmp_path / "port"),
                                     save_freq_steps=2, keep_last_n=2)
    hm = cb.HealthMonitor(action="rollback", checkpoint=ftc)
    rec = Losses(None)
    seen = {}

    class Peek(cb.Callback):
        def on_train_batch_begin(self, step, logs=None):
            if hm.rollbacks == 1 and "state" not in seen:
                seen["state"] = _state(m)
                seen["blob"] = ckpt.load(ftc.manager.path_for(2))

    m.fit(DS(), batch_size=2, epochs=2, shuffle=False, verbose=0,
          callbacks=[ftc, hm, Poison(3), rec, Peek()])
    assert hm.rollbacks == 1
    assert reg.get("health_rollback_total").total() == rb0 + 1
    rb = events.recent(20, kind="health_rollback")
    assert len(rb) == 1 and rb[0]["restored_step"] == 2
    assert np.isnan(rec.losses[3]) and np.isfinite(rec.losses).sum() == 7
    # the restore is the step-2 file, bit for bit
    for k, v in seen["blob"]["network"].items():
        assert torch.equal(seen["state"][k], v), k
    assert any(a.get("signal") == "checkpoint_skipped"
               for a in health.snapshot()["alerts_tail"])

    # the reference rolls back to the same step
    monkeypatch.setenv("PADDLE_TPU_HEALTH", "1")
    jevents.default_event_log().clear()
    jm = _ref_model()
    jftc = jcb.FaultTolerantCheckpoint(str(tmp_path / "ref"),
                                       save_freq_steps=2, keep_last_n=2)
    jhm = jcb.HealthMonitor(action="rollback", checkpoint=jftc)
    jm.fit(JDS(), batch_size=2, epochs=1, shuffle=False, verbose=0,
           callbacks=[jftc, jhm, Poison(3, jax=True)])
    jrb = jevents.recent(20, kind="health_rollback")
    assert jhm.rollbacks == 1 and jrb[0]["restored_step"] == 2
    assert jmetrics.default_registry().get(
        "health_rollback_total").total() >= 1


def test_resume_skips_a_truncated_newest_file(tmp_path):
    _, weights = _weights()
    m = _port_model(weights)
    m.fit(DS(), batch_size=2, epochs=1, shuffle=False, verbose=0,
          callbacks=[cb.FaultTolerantCheckpoint(str(tmp_path),
                                                save_freq_steps=2,
                                                keep_last_n=2)])
    mgr = ckpt.CheckpointManager(str(tmp_path))
    assert mgr.steps() == [4, 2]
    path = mgr.path_for(4)
    data = open(path, "rb").read()
    open(path, "wb").write(data[:len(data) // 3])
    skipped = metrics.default_registry().get(
        "checkpoint_corrupt_skipped_total")
    before = skipped.total()
    resumed = _port_model(seed=3)
    with pytest.warns(UserWarning, match="skipping corrupt checkpoint"):
        info = resumed._restore_for_resume(str(tmp_path))
    assert skipped.total() == before + 1
    assert info == {"epoch": 0, "skip_steps": 2, "global_step": 2}
    blob = ckpt.load(mgr.path_for(2))
    for k, v in resumed.network.state_dict().items():
        assert torch.equal(v, blob["network"][k]), k


def test_health_monitor_detectors_and_fleet_refusal():
    hm = cb.HealthMonitor(action="halt", window=4, confirm_steps=2,
                          cooldown_steps=0)
    jhm = jcb.HealthMonitor(action="halt", window=4, confirm_steps=2,
                            cooldown_steps=0)
    losses = [2.0, 2.01, 1.99, 2.0, 2.02, 50.0, 60.0, 2.0]
    for i, loss in enumerate(losses, 1):
        hm.observe(loss=loss, grad_norm=1.0, step=i)
        jhm.observe(loss=loss, grad_norm=1.0, step=i)
    assert [a["signal"] for a in hm.alerts] == \
        [a["signal"] for a in jhm.alerts]
    assert "loss_spike" in [a["signal"] for a in hm.alerts]
    with pytest.raises(NotImplementedError, match="A11"):
        cb.HealthMonitor(action="fleet")
    from paddle_tpu_torch.profiler.monitor import ThroughputMonitor
    assert cb.ThroughputMonitor is ThroughputMonitor
    assert cb.ThroughputMonitor(window=2).window == 2


def test_model_evaluate_predict_save_load(tmp_path, monkeypatch):
    torch.manual_seed(0)
    x = np.random.default_rng(0).normal(size=(12, 4)).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int64)
    net = torch.nn.Linear(4, 2)
    m = Model(net)
    m.prepare(optimizer.SGD(0.5, parameters=net.parameters()),
              F.cross_entropy, metrics=metric.Accuracy())
    ds = TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])
    m.fit(ds, batch_size=4, epochs=3, verbose=0, shuffle=True)
    logs = m.evaluate(ds, batch_size=4, verbose=0)
    assert set(logs) == {"loss", "acc"} and logs["acc"] > 0.5
    out = m.predict(ds, batch_size=4, stack_outputs=True)
    assert out[0].shape == (12, 2)
    m.save(str(tmp_path / "m"))
    m2 = Model(torch.nn.Linear(4, 2))
    m2.prepare(optimizer.SGD(0.5, parameters=m2.network.parameters()),
               F.cross_entropy)
    m2.load(str(tmp_path / "m"))
    for k, v in net.state_dict().items():
        assert torch.equal(m2.network.state_dict()[k], v)
    assert m2._pending_ts_state["t"] == 9
    assert m.summary()["total_params"] == 10
    assert len(DataLoader(ds, batch_size=5, drop_last=True)) == 2
    with pytest.raises(NotImplementedError, match="A12"):
        DataLoader(ds, num_workers=2)
    # the observability server starts with the fit and sees its steps
    from paddle_tpu_torch.profiler import server
    monkeypatch.setenv("PADDLE_TPU_METRICS_PORT", "0")
    try:
        m.fit(ds, batch_size=4, verbose=0)
        assert server.get_server() is not None
        assert server.liveness()["last_step"] == 3
    finally:
        server.stop_server()
