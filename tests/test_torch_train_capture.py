"""The captured training step's contract, on the CPU at GPTConfig.tiny():
the in-place update (masters, optimizer slots and buffers keep their
tensors), the update's scalars as device tensors, the step's graph route
(one graph per batch signature and variant, replays that return a fresh
loss), ``set_state_dict`` into the live slots, the sentinel's vector and
its trip replay on the snapshot of the incoming masters, and
``PADDLE_TPU_FUSED_OPT`` in both packages.

A CUDA graph cannot be captured on the CPU, so the graph route is driven
through ``_CPUGraphs``: it stands in for ``jit.graphs.StepGraphs`` with
the same interface, keeps the outputs of a key's first run as the
graph's static outputs and, on a "replay", runs the step again and
writes its results into those same tensors, as a replayed graph does.

Every comparison inside the port is bit for bit: the in-place update
with fp64 device scalars writes what the out-of-place update and the
eager ``Optimizer.step()`` write with Python floats.
"""
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.gpt import GPT as JGPT
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import jit, optimizer
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import lr as plr
from paddle_tpu_torch.profiler import health
from paddle_tpu_torch.utils.convert import load_numpy_params


@pytest.fixture(autouse=True)
def _clean_health_state():
    health.reset()
    yield
    health.reset()


class _CPUGraphs:
    """``StepGraphs``'s interface on the CPU (see the module docstring)."""

    def __init__(self):
        self.graphs, self.replays = {}, {}
        self.captures = self.pool_bytes = 0

    def run(self, key, fn):
        out = fn()
        if key not in self.graphs:
            self.graphs[key] = tuple(None if o is None else o.clone()
                                     for o in out)
            self.replays[key] = 0
            self.captures += 1
            return out
        static = self.graphs[key]
        for s, o in zip(static, out):
            if s is not None:
                s.copy_(o)
        self.replays[key] += 1
        return static

    def clear(self):
        self.graphs.clear()
        self.replays.clear()


def _model(cfg=None, seed=0):
    torch.manual_seed(seed)
    return GPT(cfg or GPTConfig.tiny(), device="cpu")


def _batch(seed=0, B=2, L=16, vocab=1024):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(1, vocab, (B, L))),
            torch.from_numpy(rng.integers(0, vocab, (B, L))))


OPTS = {
    "SGD": lambda ps: optimizer.SGD(0.1, parameters=ps, weight_decay=0.01),
    "Momentum": lambda ps: optimizer.Momentum(0.1, 0.9, parameters=ps),
    "Adam": lambda ps: optimizer.Adam(1e-2, parameters=ps,
                                      weight_decay=0.01),
    "AdamW": lambda ps: optimizer.AdamW(1e-2, parameters=ps,
                                        weight_decay=0.1),
}


def _ptrs(ts):
    return ({k: p.data_ptr() for k, p in ts.params.items()},
            {(k, s): v.data_ptr() for k, d in ts.opt_state.items()
             for s, v in d.items()},
            {k: b.data_ptr() for k, b in ts.buffers.items()})


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", list(OPTS))
def test_update_keeps_every_tensor_in_place(name, fused):
    """Masters, slots and buffers keep their storage over 3 steps (the
    graph reads and writes the addresses it captured), and the values
    move."""
    tm = _model()
    ts = jit.TrainStep(tm, F.cross_entropy, OPTS[name](tm.parameters()),
                       fused_opt=fused)
    assert ts.fused_opt is fused
    before = _ptrs(ts)
    p0 = {k: v.detach().clone() for k, v in ts.params.items()}
    for s in range(3):
        ts(*_batch(s))
    assert _ptrs(ts) == before
    assert all(p.requires_grad for p in ts.params.values())
    assert not all(torch.equal(p0[k], v) for k, v in ts.params.items())


def _grads(tm, params, batch, amp=None):
    """The step's gradients of ``params`` (fp32 masters) on ``batch``, as
    TrainStep forms them."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    comp = {k: (v.to(amp) if amp is not None else v)
            for k, v in leaves.items()}
    out = torch.func.functional_call(tm, comp, (batch[0],))
    g = torch.autograd.grad(F.cross_entropy(out, batch[1]),
                            list(leaves.values()))
    return dict(zip(leaves, g))


@pytest.mark.parametrize("amp", [None, torch.bfloat16])
@pytest.mark.parametrize("name", ["Momentum", "AdamW"])
def test_device_scalars_write_what_the_out_of_place_update_writes(name,
                                                                  amp):
    """TrainStep (in place; lr and t as fp64 device tensors filled from
    a scheduler before each step) against the out-of-place apply_fn and
    the eager Optimizer.step() with Python floats, over 4 steps of a
    StepDecay schedule: losses, masters and slots bit for bit."""
    def sched():
        return plr.StepDecay(0.05, step_size=2, gamma=0.5)

    tm = _model()
    ts = jit.TrainStep(tm, F.cross_entropy, {
        "Momentum": lambda: optimizer.Momentum(sched(), 0.9,
                                               parameters=tm.parameters()),
        "AdamW": lambda: optimizer.AdamW(sched(), parameters=tm.parameters(),
                                         weight_decay=0.1)}[name](),
        amp_dtype=amp)
    ref_opt = type(ts.optimizer)(**({"learning_rate": sched(),
                                     "momentum": 0.9}
                                    if name == "Momentum" else
                                    {"learning_rate": sched(),
                                     "weight_decay": 0.1}),
                                 parameters=[])
    ref_p = {k: v.detach().clone() for k, v in ts.params.items()}
    ref_s = ref_opt.init_state_tree(ref_p)
    eager_p = [torch.nn.Parameter(v.clone()) for v in ref_p.values()]
    eager_opt = type(ts.optimizer)(**({"learning_rate": sched(),
                                       "momentum": 0.9}
                                      if name == "Momentum" else
                                      {"learning_rate": sched(),
                                       "weight_decay": 0.1}),
                                   parameters=eager_p)
    for t in range(1, 5):
        batch = _batch(t)
        g = _grads(tm, ref_p, batch, amp)
        loss = ts(*batch)
        new_p, ref_s = ref_opt.apply_fn(ref_p, g, ref_s,
                                        lr=ref_opt.get_lr(), t=t,
                                        inplace=False)
        ref_p = {k: v.detach() for k, v in new_p.items()}
        for p, k in zip(eager_p, g):
            p.grad = g[k]
        eager_opt.step()
        for s in (ts.optimizer, ref_opt, eager_opt):
            s._learning_rate.step()
        assert torch.isfinite(loss)
        for i, (k, v) in enumerate(ts.params.items()):
            assert torch.equal(v, ref_p[k]), (t, k)
            assert torch.equal(v, eager_p[i]), (t, k)
            for s, sv in ts.opt_state[k].items():
                assert torch.equal(sv, ref_s[k][s]), (t, k, s)
    assert ts.optimizer.get_lr() == 0.0125


@pytest.mark.parametrize("health_on", [False, True])
def test_graph_route_returns_fresh_losses_and_trains_as_uncaptured(
        health_on, monkeypatch):
    """The graph route (``_CPUGraphs``) against the uncaptured step from
    the same weights: each call's loss is a tensor of its own whose value
    later replays leave alone, the losses and the state match bit for
    bit, and each (signature, variant) is captured once."""
    monkeypatch.setenv("PADDLE_TPU_HEALTH_INTERVAL", "2")
    steps = []
    for captured in (False, True):
        tm = _model()
        ts = jit.TrainStep(tm, F.cross_entropy, optimizer.AdamW(
            1e-2, parameters=tm.parameters()), health=health_on)
        if captured:
            ts._graphs = _CPUGraphs()
        steps.append(ts)
    plain, graphed = steps
    batches = [_batch(s) for s in range(3)] + [_batch(3, L=8)]
    runs = {}
    for ts in steps:
        losses = []
        for i in range(8):
            losses.append(ts(*batches[i % 4]))
        runs[id(ts)] = [(loss.clone(), loss) for loss in losses]
    for (a, _), (b, live) in zip(runs[id(plain)], runs[id(graphed)]):
        assert torch.equal(a, b) and torch.equal(b, live)
    ptrs = {loss.data_ptr() for _, loss in runs[id(graphed)]}
    assert len(ptrs) == 8
    for k, v in plain.params.items():
        assert torch.equal(graphed.params[k], v), k
        for s, sv in plain.opt_state[k].items():
            assert torch.equal(graphed.opt_state[k][s], sv), (k, s)
    st = graphed.stats
    variants = ({"step", "fetch:0", "fetch:1"} if health_on else {"step"})
    assert {v for _, v in st["graph_replays"]} == variants
    assert st["graph_captures"] == len(st["graph_replays"])
    assert sum(st["graph_replays"].values()) == 8 - st["graph_captures"]
    assert len({sig for sig, _ in st["graph_replays"]}) == 2
    assert plain.stats == {"graph_captures": 0, "graph_replays": {},
                           "graph_pool_bytes": 0}
    if health_on:
        assert graphed.last_health == plain.last_health | {
            "ts": graphed.last_health["ts"]}
    graphed.release_graphs()
    assert graphed.stats["graph_replays"] == {} and not graphed._static


def test_signature_keys_type_shape_device_and_values():
    a = torch.zeros(2, 3, dtype=torch.int64)
    sig = jit._signature((a, 4, [1, 2]))
    assert sig == (("int64", (2, 3), "cpu"), ("value", 4),
                   ("value", "[1, 2]"))
    assert jit._signature((a.float(),)) != jit._signature((a,))
    assert jit._signature((a[:1],)) != jit._signature((a,))


def test_set_state_dict_writes_into_the_live_slots():
    tm = _model()
    ts = jit.TrainStep(tm, F.cross_entropy, optimizer.Adam(
        1e-2, parameters=tm.parameters()))
    ts(*_batch(0))
    sd = ts.state_dict()
    ptrs = _ptrs(ts)
    ts(*_batch(1))
    ts.set_state_dict(sd)
    assert _ptrs(ts) == ptrs and ts._t == 1
    for (n, s), v in zip(ts._leaves(), sd["opt_flat"]):
        assert np.array_equal(ts.opt_state[n][s].numpy(), v), (n, s)
    bad = dict(sd, opt_flat=sd["opt_flat"][:-1])
    with pytest.raises(ValueError):
        ts.set_state_dict(bad)


def test_sentinel_vector_and_trip_replay_state_as_out_of_place(monkeypatch):
    """The fetched step's vector equals HealthProbe.stats_vec over the
    out-of-place update's (old, new) masters bit for bit, and a trip
    replays on the snapshot of the masters the step took in."""
    tm = _model()
    ts = jit.TrainStep(tm, F.cross_entropy, optimizer.Momentum(
        0.1, 0.9, parameters=tm.parameters()), health=True)
    ref_opt = optimizer.Momentum(0.1, 0.9, parameters=[])
    old = {k: v.detach().clone() for k, v in ts.params.items()}
    ref_s = ref_opt.init_state_tree(old)
    batch = _batch(0)
    g = _grads(tm, old, batch)
    loss = ts(*batch)
    new, _ = ref_opt.apply_fn(old, g, ref_s, t=1, inplace=False)
    want = ts._health_probe.stats_vec(loss, g, old, new)
    t, host, _, snap, kept = ts._pending
    assert t == 1 and kept is not None
    assert torch.equal(host, want)
    assert all(torch.equal(snap[k], v) for k, v in old.items())
    # a NaN in the incoming masters: the replay runs on the snapshot
    name = "blocks.1.ln1.weight"
    with torch.no_grad():
        ts.params[name].view(-1)[0] = float("nan")
    seen = {}

    def spy(layer, loss_fn, arrs, state=None):
        seen["state"] = {k: v.clone() for k, v in state.items()}
        return {"layer": "spy"}

    monkeypatch.setattr(health, "eager_replay", spy)
    incoming = {k: v.detach().clone() for k, v in ts.params.items()}
    ts(*batch)
    assert ts.last_health["nonfinite"]
    assert ts.last_attribution == {"layer": "spy"}
    for k, v in incoming.items():
        assert torch.equal(torch.nan_to_num(seen["state"][k]),
                           torch.nan_to_num(v)), k
    assert torch.isnan(seen["state"][name]).any()
    assert not torch.equal(torch.nan_to_num(ts.params[name]),
                           torch.nan_to_num(incoming[name]))


def test_generators_drawn_notes_explicit_generators():
    gen = torch.Generator().manual_seed(3)
    x = torch.ones(4, 8)
    with prandom.generators_drawn() as drawn:
        F.dropout(x, 0.5)
        F.dropout(x, 0.5, generator=gen)
        F.dropout(x, 0.5, generator=gen)
    assert drawn == [gen]
    with prandom.generators_drawn() as outer:
        with prandom.generators_drawn() as inner:
            F.dropout(x, 0.5, generator=gen)
        assert inner == [gen] and outer == []


@pytest.mark.parametrize("env, arg, want", [
    (None, None, True), ("0", None, False), ("off", None, False),
    ("1", None, True), ("0", True, True), (None, False, False)])
def test_fused_opt_follows_env_in_both_packages(monkeypatch, env, arg,
                                                want):
    """TrainStep(fused_opt=None) follows PADDLE_TPU_FUSED_OPT (on unless
    0/false/off/no) in both packages; an explicit value wins."""
    if env is None:
        monkeypatch.delenv("PADDLE_TPU_FUSED_OPT", raising=False)
    else:
        monkeypatch.setenv("PADDLE_TPU_FUSED_OPT", env)
    jm = JGPT(JConfig.tiny())
    tm = GPT(GPTConfig.tiny(), device="cpu")
    load_numpy_params(tm, {k: np.asarray(p.data)
                           for k, p in jm.named_parameters()})
    jst = JTrainStep(jm, JF.cross_entropy, jopt.AdamW(
        1e-3, parameters=jm.parameters()), fused_opt=arg)
    tst = jit.TrainStep(tm, F.cross_entropy, optimizer.AdamW(
        1e-3, parameters=tm.parameters()), fused_opt=arg)
    assert jst.fused_opt is want and tst.fused_opt is want
