"""The port's retrace watchdog and compile attribution against the
reference's: ``describe_delta`` strings for the same shape changes, a
``TrainStep`` of each package fed the same batch-shape change, the
serving engine's graph sites (zero retraces across a steady run, the same
site names as the reference engine's), and compile attribution under the
entry labels the port pushes, through a CPU stand-in for
``jit.graphs.StepGraphs`` that reports its captures as StepGraphs does."""
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.inference.serving import ServingEngine as JEngine
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.gpt import GPT as JGPT
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.nn import functional as JF
from paddle_tpu.profiler import watchdog as jwatchdog
from paddle_tpu_torch import _native, jit, optimizer
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.profiler import compile_watch, events, metrics, watchdog
from paddle_tpu_torch.utils.convert import load_numpy_params

_DT = {"float32": torch.float32, "int64": torch.int64, "int32": torch.int32,
       "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _fresh_watchdogs():
    for wd in (watchdog.get_watchdog(), jwatchdog.get_watchdog()):
        wd.reset()
    compile_watch.reset()
    yield
    for wd in (watchdog.get_watchdog(), jwatchdog.get_watchdog()):
        wd.reset()
    compile_watch.reset()


# (old inputs, new inputs), each [(shape, dtype)]: dims, rank, dtype,
# arity, several arguments at once, no change
_DELTAS = [
    ([((4, 8), "float32")], [((6, 8), "float32")]),
    ([((4, 8), "float32")], [((6, 9), "float32")]),
    ([((4, 8), "float32")], [((4, 8, 1), "float32")]),
    ([((4, 8), "float32")], [((4, 8), "int32")]),
    ([((4, 8), "float32")], [((4, 8), "float32"), ((2,), "int64")]),
    ([((2, 16), "int64"), ((2, 16), "int64")],
     [((3, 16), "int64"), ((3, 32), "int32")]),
    ([((), "float32")], [((1,), "float32")]),
]


@pytest.mark.parametrize("old,new", _DELTAS)
def test_describe_delta_equals_the_reference(old, new):
    def tensors(spec):
        return [torch.zeros(s, dtype=_DT[d]) for s, d in spec]

    def arrays(spec):
        return [np.zeros(s, dtype=d) for s, d in spec]

    got = watchdog.describe_delta(watchdog.signature_of(tensors(old)),
                                  watchdog.signature_of(tensors(new)))
    want = jwatchdog.describe_delta(jwatchdog.signature_of(arrays(old)),
                                    jwatchdog.signature_of(arrays(new)))
    assert got == want
    static = watchdog.describe_delta(
        watchdog.signature_of(tensors(old), {"b": 1, "a": 2}),
        watchdog.signature_of(tensors(old), {"a": 2, "b": 1}))
    assert static == "signature changed"


def test_observe_counts_hits_misses_and_retraces():
    wd = watchdog.get_watchdog()
    reg = metrics.default_registry()
    hits = reg.counter("jit_cache_hits_total").value(site="wdtest")
    events.default_event_log().clear()
    assert wd.observe("wdtest", "f", [torch.zeros(2)]) is None
    assert wd.observe("wdtest", "f", [torch.zeros(2)]) is None
    ev = wd.observe("wdtest", "f", [torch.zeros(3)])
    assert ev.delta == "arg0 shape (2,)->(3,) (dim0 2->3)"
    assert wd.counts() == {"wdtest:f": 1}
    assert reg.counter("jit_cache_hits_total").value(site="wdtest") == \
        hits + 1
    assert events.recent(5, kind="retrace")[-1]["name"] == "f"


def _batch(B, L=16, seed=0, vocab=1024):
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab, (B, L)), rng.integers(0, vocab, (B, L))


def test_train_step_retrace_delta_equals_the_reference():
    paddle.seed(0)
    jm = JGPT(JConfig.tiny())
    tm = GPT(GPTConfig.tiny(), device="cpu")
    load_numpy_params(tm, {k: np.asarray(p.data)
                           for k, p in jm.named_parameters()})
    jst = JTrainStep(jm, JF.cross_entropy,
                     jopt.SGD(0.1, parameters=jm.parameters()))
    tst = jit.TrainStep(tm, F.cross_entropy,
                        optimizer.SGD(0.1, parameters=tm.parameters()))
    for B in (2, 2, 3):
        ids, labels = _batch(B)
        jst(paddle.to_tensor(ids), paddle.to_tensor(labels))
        tst(torch.from_numpy(ids), torch.from_numpy(labels))
    # (the reference's eager dispatch retraces too, under site "eager")
    mine, ref = ([e for e in wd.events if e.site == "train_step"][-1]
                 for wd in (watchdog.get_watchdog(),
                            jwatchdog.get_watchdog()))
    assert (mine.site, mine.count, mine.delta) == (ref.site, ref.count,
                                                   ref.delta)
    assert mine.name == tst._wd_name and mine.name.startswith("GPT#")
    assert mine.delta == ("arg0 shape (2, 16)->(3, 16) (dim0 2->3); "
                          "arg1 shape (2, 16)->(3, 16) (dim0 2->3)")


_SCFG = dict(vocab_size=256, max_position_embeddings=64, hidden_size=32,
             num_layers=2, num_heads=2, dropout=0.0, attn_dropout=0.0)
_SKW = dict(max_batch=4, max_len=32, page_size=8)


def _site_names(wd, name):
    return sorted(n.replace(name, "<m>") for (s, n) in wd._seen
                  if s == "to_static" and name in n)


def test_serving_sites_show_zero_retraces_in_a_steady_run():
    """Every prompt in one prefill bucket, one to four lanes: each decode
    site (one a lane bucket) and the prefill site keep one signature, in
    both packages, and the sites are the reference's."""
    paddle.seed(1)
    jm = JGPT(JConfig(**_SCFG))
    jm.eval()
    tm = GPT(GPTConfig(**_SCFG), device="cpu")
    load_numpy_params(tm, {k: np.asarray(p.data)
                           for k, p in jm.named_parameters()})
    tm.eval()
    rng = np.random.default_rng(2)
    work = [(rng.integers(1, 256, int(n)).tolist(), int(m))
            for n, m in zip(rng.integers(9, 16, 10), rng.integers(2, 6, 10))]
    engines = [JEngine(jm, name="wd-j", **_SKW),
               ServingEngine(tm, name="wd-t", device="cpu", **_SKW)]
    try:
        outs = []
        for eng in engines:
            for wave in (work[:1], work[1:3], work[3:]):
                reqs = [eng.submit(p, max_new_tokens=n) for p, n in wave]
                eng.run_until_idle()
                outs.append([r.result(timeout=30) for r in reqs])
        assert outs[:3] == outs[3:]
    finally:
        for eng in engines:
            eng.close()
    wd, jwd = watchdog.get_watchdog(), jwatchdog.get_watchdog()
    assert wd.total_retraces() == 0
    # (the reference's eager dispatch retraces under site "eager")
    assert jwd.total_retraces("to_static") == 0
    assert _site_names(wd, "wd-t") == _site_names(jwd, "wd-j")
    assert "serving_decode:<m>:w4" in _site_names(wd, "wd-t")
    hits = metrics.default_registry().counter("jit_cache_hits_total")
    assert hits.value(site="to_static") > 0


class _CPUGraphs:
    """``StepGraphs``'s interface on the CPU: a key's first use runs the
    step and reports one ``graph_capture`` to compile attribution, as
    ``StepGraphs._capture`` does; later uses run it again as a replay."""

    def __init__(self):
        self.graphs, self.replays = {}, {}
        self.captures = self.pool_bytes = 0

    def run(self, key, fn):
        if key in self.graphs:
            self.replays[key] += 1
            return fn()
        t0 = time.perf_counter()
        out = fn()
        compile_watch.record("graph_capture", time.perf_counter() - t0)
        self.graphs[key] = (None, {}, None)
        self.replays[key] = 0
        self.captures += 1
        return out

    def clear(self):
        self.graphs.clear()
        self.replays.clear()


def test_compile_attribution_under_the_port_entry_labels():
    torch.manual_seed(0)
    tm = GPT(GPTConfig(**_SCFG), device="cpu")
    tm.eval()
    eng = ServingEngine(tm, name="cw", device="cpu", **_SKW)
    eng._step_graphs = _CPUGraphs()
    step = jit.TrainStep(GPT(GPTConfig.tiny(), device="cpu"),
                         F.cross_entropy, optimizer.SGD(
                             0.1, parameters=tm.parameters()))
    step._graphs = _CPUGraphs()
    reg = metrics.default_registry()
    n0 = reg.counter("xla_compiles_total").value(entry="to_static:"
                                                       "serving_decode:cw")
    try:
        for p in ([5, 6, 7], [8, 9, 10, 11]):
            eng.submit(p, max_new_tokens=3)
            eng.run_until_idle()
        for B in (2, 2, 3):
            step(*(torch.from_numpy(a) for a in _batch(B)))
    finally:
        eng.close()
    summ = compile_watch.summary()
    train = summ[f"train_step:{step._wd_name}"]
    assert train["count"] == 2 == train["phases"]["graph_capture"]["count"]
    # one capture a (bucket, variant) and a lane bucket
    assert summ["to_static:serving_prefill:cw"]["count"] == \
        len(eng._step_graphs.graphs) - summ[
            "to_static:serving_decode:cw"]["count"] == 1
    assert summ["to_static:serving_decode:cw"]["count"] == 1
    assert reg.counter("xla_compiles_total").value(
        entry="to_static:serving_decode:cw") == n0 + 1
    comp = watchdog.get_watchdog().snapshot()["compiles"]
    assert comp[f"train_step:{step._wd_name}"]["count"] == 2
    assert compile_watch.current_entry() == "unattributed"


def test_kernel_build_reports_and_first_step_gauge(monkeypatch):
    reg = metrics.default_registry()
    ev = reg.counter("xla_compile_cache_events_total")
    hit, miss = ev.value(event="hit"), ev.value(event="miss")
    prev = compile_watch.push_entry("train_step", "Net#1")
    try:
        _native._report_build(None)
        _native._report_build(12.5)
    finally:
        compile_watch.pop_entry(prev)
    assert (ev.value(event="hit"), ev.value(event="miss")) == (hit + 1,
                                                              miss + 1)
    phases = compile_watch.summary()["train_step:Net#1"]["phases"]
    assert phases == {"kernel_build": {"count": 1, "seconds": 12.5}}
    with pytest.raises(ValueError, match="no_such_phase"):
        compile_watch.record("no_such_phase", 1.0)
    assert compile_watch.summary()["train_step:Net#1"]["count"] == 1
    monkeypatch.setenv("PADDLE_TPU_ELASTIC_RESTART_NUM", "3")
    compile_watch.note_first_step()
    g = reg.get("relaunch_to_first_step_seconds")
    assert g.value(generation="3") > 0
    assert compile_watch.install() and compile_watch.installed()
