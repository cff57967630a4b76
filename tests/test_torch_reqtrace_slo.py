"""The port's request tracer, SLO tracker and the serving engine that feeds
them, against the JAX package's, on the CPU.

The same lifecycle calls give the same trace snapshot (timestamps, trace
ids and durations aside), the same observations give the same window
quantiles and the same breach events, and the two engines, serving the
same weights and workload under preemption, leave the same per-request
traces, admission and eviction events, metric counts and introspection
ring.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.serving import ServingEngine as JEngine
from paddle_tpu.models.gpt import GPT as JGPT
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.profiler import events as jevents
from paddle_tpu.profiler import metrics as jmetrics
from paddle_tpu.profiler import reqtrace as jreqtrace
from paddle_tpu.profiler import slo as jslo
from paddle_tpu_torch.inference import serving
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.profiler import events, metrics, reqtrace, slo
from paddle_tpu_torch.utils.convert import load_numpy_params

_CFG = dict(vocab_size=256, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=2, dropout=0.0, attn_dropout=0.0)

#: per-trace fields that hold clock readings or process-wide counters
_CLOCK = ("trace_id", "e2e_s", "start", "end", "rid")


def _norm_trace(t):
    out = {k: v for k, v in t.items() if k not in _CLOCK}
    out["phases"] = sorted(t["phases"])
    out["spans"] = [{k: v for k, v in s.items() if k not in _CLOCK}
                    for s in t["spans"]]
    return out


def _norm_snapshot(snap):
    return dict(snap, live=[_norm_trace(t) for t in snap["live"]],
                completed=[_norm_trace(t) for t in snap["completed"]])


def _lifecycle(mod, model):
    """One scripted run of every tracer hook: a request decoded past one
    span bucket and preempted and re-admitted, one failed, one live."""
    tr = mod.RequestTracer(model, ring=8, decode_every=3)
    tr.submit(1)
    tr.admitted(1, bucket=16, prompt_tokens=9, shared_tokens=8)
    tr.prefill_done(1)
    for i in range(5):
        tr.decode_iteration(1, bucket=4 if i < 4 else 2, path="fused")
    tr.preempted(1)
    tr.admitted(1, bucket=16, prompt_tokens=14, requeue=True)
    tr.prefill_done(1)
    tr.decode_iteration(1, bucket=2, path="fused")
    tr.complete(1, "length")
    tr.submit(2)
    tr.admitted(2, bucket=8, prompt_tokens=3)
    tr.complete(2, "failed", error="KV page pool exhausted")
    tr.submit(3)
    tr.admitted(3, bucket=8, prompt_tokens=5)
    tr.prefill_done(3)
    tr.decode_iteration(3, bucket=1, path="eager", tokens=2)
    return tr


def test_tracer_snapshot_matches_reference(tmp_path):
    got = _lifecycle(reqtrace, "trace-parity").snapshot(10)
    ref = _lifecycle(jreqtrace, "trace-parity").snapshot(10)
    assert _norm_snapshot(got) == _norm_snapshot(ref)
    assert [t["state"] for t in got["completed"]] == ["complete", "failed"]
    tr = _lifecycle(reqtrace, "trace-export")
    assert tr.export_jsonl(str(tmp_path / "t.jsonl")) == 2
    chrome = reqtrace.to_chrome_trace(tr.completed())
    ref_chrome = jreqtrace.to_chrome_trace(
        _lifecycle(jreqtrace, "trace-export").completed())
    assert [(e["name"], e["args"].get("bucket")) for e in
            chrome["traceEvents"]] == [(e["name"], e["args"].get("bucket"))
                                       for e in ref_chrome["traceEvents"]]


def _observe(mod, model):
    tracker = mod.SLOTracker(model, window=16, min_samples=4,
                             targets={"ttft": 0.5, "tpot": 0.025})
    rng = np.random.default_rng(2)
    for v in np.concatenate([rng.uniform(0.1, 0.3, 6),
                             rng.uniform(0.6, 0.9, 10),
                             rng.uniform(0.1, 0.2, 20)]):
        tracker.observe("ttft", float(v))
        tracker.observe("tpot", float(v) / 20)
        tracker.observe("queue_wait", float(v) / 3)
    tracker.observe("e2e", 1.5)
    return tracker


def _breaches(mod, model):
    return [{k: v for k, v in e.items() if k not in ("ts", "host")}
            for e in mod.recent(1000, kind="slo_breach")
            if e.get("model") == model]


def test_slo_windows_and_breaches_match_reference():
    got = _observe(slo, "slo-parity")
    ref = _observe(jslo, "slo-parity")
    assert got.snapshot() == ref.snapshot()
    assert got.stats["breaches"] == 2 and got.stats["recoveries"] == 2
    assert _breaches(events, "slo-parity") == _breaches(jevents, "slo-parity")
    assert len(_breaches(events, "slo-parity")) == 2  # one excursion each
    assert got.status() == "ok"
    with pytest.raises(ValueError):
        got.observe("latency", 1.0)


@pytest.fixture(scope="module")
def served():
    """Both engines over the same weights and workload, on a pool small
    enough to preempt."""
    paddle.seed(5)
    jm = JGPT(JConfig(**_CFG))
    jm.eval()
    tm = GPT(GPTConfig(**_CFG), device="cpu")
    load_numpy_params(tm, {k: np.asarray(p.data)
                           for k, p in jm.named_parameters()})
    rng = np.random.default_rng(8)
    b = rng.integers(1, 256, 5).tolist()
    work = [(b, 6), (b, 6), (rng.integers(1, 256, 11).tolist(), 7),
            (rng.integers(1, 256, 3).tolist(), 4)]
    kw = dict(max_batch=2, max_len=32, page_size=8, num_pages=4)
    out = {}
    for key, eng in (("port", serving.ServingEngine(
            tm, name="obs-port", device="cpu", **kw)),
                     ("ref", JEngine(jm, name="obs-port", **kw))):
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in work]
        eng.run_until_idle()
        out[key] = (eng, reqs)
    return out


def test_engine_traces_match_reference(served):
    (te, treqs), (je, jreqs) = served["port"], served["ref"]
    assert [r.result() for r in treqs] == [r.result() for r in jreqs]
    assert te.stats["preemptions"] == je.stats["preemptions"] > 0
    got, ref = te.requests_snapshot(10), je.requests_snapshot(10)
    assert set(got) == set(ref)
    assert [_norm_trace(t) for t in got["completed"]] == \
        [_norm_trace(t) for t in ref["completed"]]
    assert got["live"] == [] and got["occupancy"] == 0
    assert all(r.trace_id is not None for r in treqs)
    strip = ("ts", "host", "request", "queue_wait_s")
    for kind in ("serving_admission", "serving_eviction"):
        assert [{k: v for k, v in e.items() if k not in strip}
                for e in events.recent(1000, kind=kind)
                if e["model"] == "obs-port"] == \
            [{k: v for k, v in e.items() if k not in strip}
             for e in jevents.recent(1000, kind=kind)
             if e["model"] == "obs-port"], kind
    drop = ("ts",)
    assert [{k: v for k, v in s.items() if k not in drop}
            for s in te.introspection(100)] == \
        [{k: v for k, v in s.items() if k not in drop}
         for s in je.introspection(100)]


def test_engine_metrics_and_registry(served):
    te, treqs = served["port"]
    je, _ = served["ref"]
    reg, jreg = metrics.default_registry(), jmetrics.default_registry()
    for name, labels in (("serving_goodput_tokens_total", {}),
                         ("serving_ttft_seconds", {"path": "fused"}),
                         ("serving_tpot_seconds", {"path": "fused"}),
                         ("serving_batch_occupancy", {}),
                         ("serving_queue_depth", {})):
        got = [v for v in reg.get(name).snapshot()["values"]
               if v["labels"] == {"model": "obs-port", **labels}]
        ref = [v for v in jreg.get(name).snapshot()["values"]
               if v["labels"] == {"model": "obs-port", **labels}]
        assert len(got) == len(ref) == 1, name
        for key in ("value", "count"):
            assert got[0].get(key) == ref[0].get(key), (name, key)
    assert reg.get("serving_goodput_tokens_total").value(
        model="obs-port") == sum(len(r.generated) for r in treqs)
    snap = te.slo.snapshot()["signals"]
    assert snap["ttft"]["count"] == snap["e2e"]["count"] == len(treqs)
    assert serving.current_engine("obs-port") is te
    assert te in serving.live_engines()
    assert te.generate([4, 5, 6], max_new_tokens=2)["trace_id"] is not None
    te.close()
    assert te not in serving.live_engines()
    assert serving.current_engine("obs-port") is None
