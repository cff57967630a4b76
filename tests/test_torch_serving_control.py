"""The port's serving control plane (weight swap, rollback, canary,
restart, the admission gates and the MemoryGovernor), against the JAX
package's on the CPU with the same weights.

The reference swaps by rebinding its parameter dict and restarts by
building a new cache; the port copies the new weights into the live
parameters' storage and zeroes the KV plane in place, since a captured
graph reads both at fixed addresses. So, besides the reference's tokens,
perplexities, page counts and governor decisions, these tests hold the
port to its own rule: after a swap every live parameter keeps its
storage and holds the candidate's values, and no graph is captured
again (counted through a CPU stand-in of ``jit.graphs.StepGraphs``).
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.fault import inject as jinject
from paddle_tpu.inference.governor import MemoryGovernor as JGovernor
from paddle_tpu.inference.serving import EngineSuspended as JSuspended
from paddle_tpu.inference.serving import ServingEngine as JEngine
from paddle_tpu.models.gpt import GPT as JGPT
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu_torch.fault import inject
from paddle_tpu_torch.inference import EngineSuspended, MemoryGovernor
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.profiler import events
from paddle_tpu_torch.utils.convert import load_numpy_params

_CFG = dict(vocab_size=256, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=2, dropout=0.0, attn_dropout=0.0)
_KW = dict(max_batch=2, max_len=32, page_size=8)


def _jax_model(seed):
    paddle.seed(seed)
    m = JGPT(JConfig(**_CFG))
    m.eval()
    return m


@pytest.fixture(scope="module")
def weights():
    """Two seeded weight sets: the reference's models and their numpy
    arrays (the swap candidates)."""
    out = {}
    for name, seed in (("a", 3), ("b", 5)):
        jm = _jax_model(seed)
        out[name] = (jm, {k: np.asarray(p.data)
                          for k, p in jm.named_parameters()})
    return out


def _port(arrays):
    """A port model of its own (a swap writes the model it serves)."""
    tm = GPT(GPTConfig(**_CFG), device="cpu")
    load_numpy_params(tm, arrays)
    tm.eval()
    return tm


class _CPUGraphs:
    """``StepGraphs``'s interface on the CPU: first use of a key counts a
    capture, later uses a replay; the step runs each time."""

    def __init__(self):
        self.graphs, self.replays = {}, {}
        self.captures = self.pool_bytes = 0

    def run(self, key, fn):
        if key in self.graphs:
            self.replays[key] += 1
        else:
            self.graphs[key] = (None, {}, None)
            self.replays[key] = 0
            self.captures += 1
        return fn()


def _work(seed, n=2, new=8):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 256, int(rng.integers(5, 9))).tolist(), new)
            for _ in range(n)]


def _run(eng, work, steps_before=None, act=None):
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in work]
    if act is not None:
        for _ in range(steps_before):
            eng.step()
        act()
    eng.run_until_idle()
    return [r.result(timeout=5) for r in reqs]


def _scenario(eng, candidate, captures=None):
    """A swap while two requests are in flight, requests on the new
    weights, a rollback, and a restart mid-decode; the tokens of each."""
    w1, w2 = _work(1), _work(2)
    out = {"mid_swap": _run(eng, w1, 3, lambda: eng.request_swap(
        candidate, step=7, source="test"))}
    if captures is not None:
        captures.append(eng.stats["graph_captures"])
    out["swapped"] = _run(eng, w2)
    eng.rollback_weights()
    out["rolled_back"] = _run(eng, w2)
    info = {}
    out["restarted"] = _run(eng, w1, 3, lambda: info.update(
        eng.restart(reason="test")))
    out["requeued"] = info["requeued"]
    out["weights_step"] = eng.weights_step
    out["swaps"] = (eng.stats["swaps"], eng.stats["restarts"],
                    eng.last_swap["action"])
    if captures is not None:
        captures.append(eng.stats["graph_captures"])
    return out


def test_swap_rollback_restart_give_the_reference_tokens(weights):
    (ja, a), (jb, b) = weights["a"], weights["b"]
    ref = _scenario(JEngine(ja, name="j-ctl", **_KW),
                    {k: p.data for k, p in jb.named_parameters()})
    assert ref["requeued"] == 2 and ref["weights_step"] is None
    captures = []
    fused = ServingEngine(_port(a), name="f-ctl", device="cpu", **_KW)
    fused._step_graphs = _CPUGraphs()
    got = {"fused": _scenario(fused, b, captures),
           "eager": _scenario(ServingEngine(_port(a), name="e-ctl",
                                            decode_mode="eager",
                                            device="cpu", **_KW), b)}
    for mode, out in got.items():
        assert out == ref, mode
    # the swap and the restart capture nothing: the graphs read the
    # weights and the KV plane where they always lay
    assert captures[0] == captures[1] == len(fused._graphs) > 0
    # after the swap: a fresh engine's tokens on the new weights; after
    # the rollback and the restart: an untouched engine's on the old
    fresh_b = ServingEngine(_port(b), device="cpu", **_KW)
    fresh_a = ServingEngine(_port(a), device="cpu", **_KW)
    assert ref["swapped"] == _run(fresh_b, _work(2))
    assert ref["rolled_back"] == _run(fresh_a, _work(2))
    assert ref["restarted"] == _run(fresh_a, _work(1))
    assert ref["mid_swap"] != ref["restarted"]


def test_swap_copies_into_the_live_storage(weights):
    """The rule a captured graph needs: no parameter is rebound. After
    the apply each live parameter keeps its storage and holds the
    candidate's values, and the staged tensors hold the outgoing ones
    (the rollback set); a rollback copies them back the same way."""
    a, b = weights["a"][1], weights["b"][1]
    tm = _port(a)
    eng = ServingEngine(tm, name="inplace", device="cpu", **_KW)
    live = dict(tm.named_parameters())
    ptrs = {k: p.data_ptr() for k, p in live.items()}
    before = {k: p.detach().clone() for k, p in live.items()}
    staged = eng.request_swap(b, step=11)
    assert all(torch.equal(p, before[k]) for k, p in live.items())
    assert eng.step() == 0  # idle: the boundary applies it
    assert eng._pending_swap is None and eng.weights_step == 11
    for k, p in tm.named_parameters():
        assert p is live[k] and p.data_ptr() == ptrs[k], k
        assert torch.equal(p, torch.tensor(b[k])), k
        assert torch.equal(staged["params"][k], before[k]), k
    assert eng._prev_weights[0] is staged["params"]
    assert eng.last_swap["action"] == "swap" and eng.last_swap["pause_s"] >= 0
    eng.rollback_weights()
    eng.step()
    for k, p in tm.named_parameters():
        assert p.data_ptr() == ptrs[k] and torch.equal(p, before[k]), k
    assert eng.weights_step is None and eng.stats["swaps"] == 2
    assert eng.last_swap["action"] == "rollback"
    kinds = [(e["action"], e.get("rollback")) for e in events.recent(
        20, kind="serving_swap") if e.get("model") == "inplace"]
    assert kinds == [("stage", False), ("swap", None), ("stage", True),
                     ("rollback", None)]


def test_swap_rejections_match_the_reference(weights):
    ja, a = weights["a"]
    je = JEngine(ja, name="j-rej", **_KW)
    te = ServingEngine(_port(a), name="t-rej", device="cpu", **_KW)
    jp = {k: p.data for k, p in ja.named_parameters()}
    key = "blocks.0.attn.qkv.weight"
    bad_shape = np.zeros((3, 3), np.float32)
    for jbad, tbad in (({k: v for k, v in jp.items() if k != key},
                        {k: v for k, v in a.items() if k != key}),
                       (dict(jp, **{key: paddle.to_tensor(bad_shape)}),
                        dict(a, **{key: bad_shape})),
                       (dict(jp, **{key: paddle.to_tensor(a[key].astype(
                           np.float16))}),
                        dict(a, **{key: a[key].astype(np.float16)}))):
        with pytest.raises(ValueError, match="swap rejected") as want:
            je.request_swap(jbad)
        with pytest.raises(ValueError, match="swap rejected") as got:
            te.request_swap(tbad)
        assert str(got.value).split(" is ")[0] == str(want.value).split(
            " is ")[0]
        assert te._pending_swap is None and je._pending_swap is None
    with pytest.raises(RuntimeError, match="no previous weights"):
        te.rollback_weights()


def test_canary_matches_the_reference(weights):
    """Perplexity of a probe batch under the live weights and under a
    candidate, to rtol 1e-5; the live storage stays untouched, and the
    candidate may come as numpy arrays or tensors."""
    (ja, a), (jb, b) = weights["a"], weights["b"]
    probe = np.random.default_rng(4).integers(1, 256, (2, 12))
    je = JEngine(ja, name="j-canary", **_KW)
    tm = _port(a)
    te = ServingEngine(tm, name="t-canary", device="cpu", **_KW)
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    want = (je.run_canary(probe),
            je.run_canary(probe, {k: p.data
                                  for k, p in jb.named_parameters()}))
    got = (te.run_canary(probe), te.run_canary(probe, b))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[0] != got[1]
    assert te.run_canary(probe, {k: torch.from_numpy(v)
                                 for k, v in b.items()}) == got[1]
    for k, p in tm.named_parameters():
        assert torch.equal(p, before[k]), k
    with pytest.raises(ValueError, match="probe batch"):
        te.run_canary(probe[:, :1])


def test_gates_match_the_reference(weights):
    """The queue cap, suspension with Retry-After and parked pages, with
    the reference's messages, counts and status values."""
    ja, a = weights["a"]
    kw = dict(max_batch=1, max_len=48, page_size=8)
    engines = (JEngine(ja, name="gates", **kw),
               ServingEngine(_port(a), name="gates", device="cpu", **kw))
    seen = []
    for eng, susp in zip(engines, (JSuspended, EngineSuspended)):
        rec = []
        eng.set_queue_limit(2)
        eng.submit([1, 2, 3], max_new_tokens=2)
        eng.submit([4, 5, 6], max_new_tokens=2)
        with pytest.raises(RuntimeError, match="shed cap") as e:
            eng.submit([7, 8, 9], max_new_tokens=2)
        rec.append(str(e.value))
        rec.append(eng.status()["queue_limit"])
        eng.set_queue_limit(None)
        eng.submit([7, 8, 9], max_new_tokens=2)
        eng.run_until_idle()
        eng.suspend(reason="memory_pressure", retry_after_s=7.5)
        with pytest.raises(susp) as e:
            eng.submit([1, 2, 3], max_new_tokens=2)
        rec += [str(e.value), e.value.retry_after_s, e.value.reason]
        st = eng.status()["suspended"]
        rec.append({k: v for k, v in st.items() if k != "ts"})
        eng.resume_admissions()
        assert eng.status()["suspended"] is None
        r = eng.submit([1, 2, 3], max_new_tokens=2)
        eng.run_until_idle()
        rec.append(r.result(timeout=5))
        free0 = eng.allocator.free_pages
        for frac in (0.5, 0.25, 2.0):
            parked = eng.shrink_pool(frac)
            rec += [parked, eng.allocator.free_pages,
                    eng.status()["reserved_pages"]]
        rec += [eng.restore_pool(), eng.allocator.free_pages == free0,
                eng.status()["reserved_pages"]]
        seen.append(rec)
    assert seen[0] == seen[1]


def test_restart_keeps_parked_pages_and_status(weights):
    ja, a = weights["a"]
    seen = []
    for eng in (JEngine(ja, name="j-park", **_KW),
                ServingEngine(_port(a), name="t-park", device="cpu", **_KW)):
        parked = eng.shrink_pool(0.5)
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in _work(3)]
        eng.step()
        info = eng.restart(reason="drill")
        seen.append((parked, info, eng.allocator.reserved_pages,
                     eng.allocator.free_pages, eng.status()["stats"][
                         "restarts"]))
        eng.run_until_idle()
        seen.append([r.result(timeout=5) for r in reqs])
        assert eng.allocator.outstanding() == {}
    assert seen[:2] == seen[2:]


def test_restart_with_the_loop_thread(weights):
    """restart() joins the running loop, requeues the in-flight requests
    and starts the loop again; they finish with an unrestarted run's
    tokens."""
    a = weights["a"][1]
    work = _work(5, new=12)
    want = _run(ServingEngine(_port(a), device="cpu", **_KW), work)
    eng = ServingEngine(_port(a), name="t-loop", device="cpu", **_KW)
    eng.start(poll_s=0.001)
    try:
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in work]
        deadline = time.monotonic() + 30
        while min(len(r.generated) for r in reqs) < 2 \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        info = eng.restart(reason="wedged")
        got = [r.result(timeout=30) for r in reqs]
    finally:
        eng.close()
    assert info["restarted_thread"] is True
    assert got == want and eng.stats["restarts"] == 1
    assert eng.allocator.outstanding() == {}


def test_wedge_drill_matches_the_reference(weights, monkeypatch):
    """An armed ``serving.wedge`` delay stalls step() before any progress:
    while it sleeps the engine reads wedged, and after the step it does
    not, in both packages."""
    monkeypatch.setenv("PADDLE_TPU_FAULT_DELAY", "0.6")
    ja, a = weights["a"]
    seen = []
    for inj, eng in ((jinject, JEngine(ja, name="j-wedge", **_KW)),
                     (inject, ServingEngine(_port(a), name="t-wedge",
                                            device="cpu", **_KW))):
        inj.reset()
        eng.generate([1, 2, 3], max_new_tokens=2)  # compile / warm up
        inj.configure("serving.wedge", times=1, kind="delay")
        try:
            r = eng.submit([4, 5, 6, 7], max_new_tokens=3)
            eng._last_progress = time.monotonic()
            t = threading.Thread(target=eng.step)
            t.start()
            time.sleep(0.35)
            during = eng.wedged(stall_after=0.25)
            t.join()
            after = eng.wedged(stall_after=0.25)
            eng.run_until_idle()
            seen.append((during, after, eng.wedged(stall_after=0.0),
                         inj.default_injector().fired("serving.wedge"),
                         r.result(timeout=5)))
            assert eng.last_progress_age() >= 0
        finally:
            inj.reset()
    assert seen[0] == seen[1] and seen[0][:4] == (True, False, False, 1)


def _governed(engine_cls, model_of):
    return (engine_cls(model_of(), name="hi", priority=10, max_batch=1,
                       max_len=48, page_size=8),
            engine_cls(model_of(), name="lo", priority=1, max_batch=1,
                       max_len=48, page_size=8))


def _ladder(gov_cls, hi, lo):
    """The reference test's scripted ladder (tests/test_serving_controller
    .py TestMemoryGovernor), run to its end: decisions, engine states and
    the recovery in reverse priority order."""
    pressure = {"bytes": 100}
    gov = gov_cls(limit_bytes=50, retry_after_s=3.0,
                  sampler=lambda: pressure["bytes"], engines=lambda: [hi, lo])

    def tick():
        d = gov.tick()
        return d if d is None else {k: v for k, v in d.items() if k != "ts"}
    out = [tick() for _ in range(4)]
    out += [gov.status()["degraded"], tick()]  # fully degraded: no action
    pressure["bytes"] = 45  # below the limit, above 0.85 of it: hold
    out.append(tick())
    pressure["bytes"] = 10
    out += [tick() for _ in range(4)]
    out += [gov.status()["degraded"], tick(), hi.allocator.reserved_pages,
            lo.allocator.reserved_pages, lo.status()["suspended"]]
    return out


def test_memory_governor_decisions_match_the_reference(weights):
    ja, a = weights["a"]
    want = _ladder(JGovernor, *_governed(JEngine, lambda: ja))
    events.default_event_log().clear()
    hi, lo = _governed(lambda m, **kw: ServingEngine(m, device="cpu", **kw),
                       lambda: _port(a))
    got = _ladder(MemoryGovernor, hi, lo)
    assert got == want
    ladder = ["shrink_pool", "suspend", "shrink_pool", "suspend", "resume",
              "restore_pool", "resume", "restore_pool"]
    assert [(d["action"], d["model"]) for d in got[:4] + got[7:11]] == list(
        zip(ladder, ["lo", "lo", "hi", "hi", "hi", "hi", "lo", "lo"]))
    kinds = [e["action"] for e in events.recent(50, kind="controller_decision")
             if e.get("policy") == "serving_memory"]
    assert kinds == ladder
    # inert without a limit; by default a CPU engine's in-use bytes are
    # its page pools'
    assert MemoryGovernor(limit_bytes=0, sampler=lambda: 10 ** 12,
                          engines=lambda: [hi, lo]).tick() is None
    gov = MemoryGovernor(limit_bytes=1, engines=lambda: [hi, lo])
    assert gov.in_use_bytes([hi, lo]) == hi.pool_bytes() + lo.pool_bytes()


def test_the_unported_machinery_raises_naming_its_item(weights):
    eng = ServingEngine(_port(weights["a"][1]), device="cpu", **_KW)
    assert eng.tp_degree() == 1
    assert eng.handoff_source is None and eng.on_preempt_requeue is None
    with pytest.raises(NotImplementedError, match="A13"):
        eng.audit()
    with pytest.raises(NotImplementedError, match="A11"):
        eng.admit_handoff(object())
    for attr in ("handoff_source", "on_preempt_requeue"):
        with pytest.raises(NotImplementedError, match="A11"):
            setattr(eng, attr, object())
        setattr(eng, attr, None)
    with pytest.raises(NotImplementedError, match="A12"):
        eng.restart(term=3)
    with pytest.raises(NotImplementedError, match="A12"):
        eng.set_queue_limit(4, term=3)
    assert eng.stats["restarts"] == 0 and eng.queue_limit is None
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.restart()
