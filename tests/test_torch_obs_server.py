"""The port's ObservabilityServer against the reference's, both on port 0
in one process: the same status codes and JSON keys for /healthz
(starting, healthy, stalled), /events, /metrics families, /snapshot,
/profile (202, 400, 409), /requests and /slo (404 without an engine),
/controller (404); ``POST /generate`` on a reference tiny-GPT engine and
on the port's CPU engine with the weights carried across gives the same
greedy tokens; the 400, 429 and 503 answers (suspended, with
Retry-After; wedged) match; ``maybe_start_server`` and its refusals of
the fleet pieces.

Every server is stopped and every engine closed by a fixture, and each
package's engine registry is this test's alone (engines other tests
leave alive never answer here)."""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import serving as jserving_mod
from paddle_tpu.inference.serving import ServingEngine as JEngine
from paddle_tpu.models.gpt import GPT as JGPT
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.profiler import events as jevents
from paddle_tpu.profiler import server as jserver
from paddle_tpu.profiler import slo as jslo
from paddle_tpu.profiler import xplane as jxplane
from paddle_tpu_torch.inference import serving as serving_mod
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.profiler import events, server, slo, watchdog, xplane
from paddle_tpu_torch.utils.convert import load_numpy_params

_CFG = dict(vocab_size=512, max_position_embeddings=128, hidden_size=32,
            num_layers=2, num_heads=2, dropout=0.0, attn_dropout=0.0)


def _get(port, path, timeout=30):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return r.status, r.read().decode(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def _post(port, path, body, timeout=60):
    data = body if isinstance(body, bytes) else body.encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def _fresh_liveness():
    for mod in (server, jserver):
        with mod._liveness_lock:
            mod._liveness.update(step=None, ts=None, wall_ts=None)


@pytest.fixture()
def both(monkeypatch):
    """(port's server, reference's server), each package's engine
    registry and SLO tracker this test's own; every engine made through
    `engines` is closed at the end."""
    for mod in (serving_mod, jserving_mod):
        monkeypatch.setattr(mod, "_engine_refs", [])
    for mod in (slo, jslo):
        monkeypatch.setattr(mod, "_current", None)
    monkeypatch.delenv("PADDLE_TPU_SERVING_QUEUE_LIMIT", raising=False)
    # tests/test_obs_server.py patches the reference's `_engine`
    # staticmethod and undoes it, which leaves a plain function on the
    # class: put the staticmethod back when this file shares its process
    for cls in (server.ObservabilityServer, jserver.ObservabilityServer):
        fn = cls.__dict__["_engine"]
        if not isinstance(fn, staticmethod):
            monkeypatch.setattr(cls, "_engine", staticmethod(fn))
    # and a capture summary another test of this process left behind
    for mod in (xplane, jxplane):
        monkeypatch.setattr(mod._default_capture, "last_summary", None)
    _fresh_liveness()
    srvs = (server.ObservabilityServer(), jserver.ObservabilityServer())
    for s in srvs:
        s.start(0)
    try:
        yield srvs
    finally:
        for s in srvs:
            s.stop()
        _fresh_liveness()


@pytest.fixture()
def engines():
    made = []

    def make(name, **kw):
        kw.setdefault("max_batch", 2)
        kw.update(max_len=48, page_size=8)
        paddle.seed(0)
        jm = JGPT(JConfig(**_CFG))
        jm.eval()
        tm = GPT(GPTConfig(**_CFG), device="cpu")
        load_numpy_params(tm, {k: np.asarray(p.data)
                               for k, p in jm.named_parameters()})
        tm.eval()
        pair = (ServingEngine(tm, name=name, device="cpu", **kw),
                JEngine(jm, name=name, **kw))
        made.extend(pair)
        return pair

    yield make
    for eng in made:
        eng.close()


def _both_get(srvs, path):
    out = []
    for s in srvs:
        code, body, hdrs = _get(s.port, path)
        out.append((code, json.loads(body) if body.startswith("{")
                    else body, hdrs))
    return out


def _same_shape(a, b):
    """Equal status codes and JSON keys."""
    assert a[0] == b[0], (a, b)
    if isinstance(a[1], dict):
        assert set(a[1]) == set(b[1]), (a[1], b[1])


def test_healthz_starting_healthy_stalled(both, monkeypatch):
    mine, ref = _both_get(both, "/healthz")
    _same_shape(mine, ref)
    assert mine[0] == 200 and mine[1]["status"] == "starting"
    server.note_step(1)
    jserver.note_step(1)
    mine, ref = _both_get(both, "/healthz")
    _same_shape(mine, ref)
    assert mine[1]["status"] == "healthy" and mine[1]["last_step"] == 1
    for s in both:
        monkeypatch.setattr(s, "stall_after", 0.0)
    mine, ref = _both_get(both, "/healthz")
    _same_shape(mine, ref)
    assert mine[0] == 503 and mine[1]["status"] == "stalled"


def test_note_step_dedupes_and_follows_new_runs():
    _fresh_liveness()
    for mod in (server, jserver):
        mod.note_step(5)
        mod.note_step(5)
        ts = mod._liveness["ts"]
        mod.note_step(5)
        assert mod._liveness["ts"] == ts
        mod.note_step(2)  # a new run in this process
        assert mod.liveness()["last_step"] == 2
    _fresh_liveness()


def test_events_metrics_snapshot_controller(both):
    for log in (events.default_event_log(), jevents.default_event_log()):
        log.clear()
    for mod in (events, jevents):
        for i in range(4):
            mod.emit("retrace", name="srvtest", seq=i)
            mod.emit("xla_compile", seq=i)
    mine, ref = _both_get(both, "/events?kind=retrace&n=3")
    _same_shape(mine, ref)
    assert [e["seq"] for e in mine[1]["events"]] == \
        [e["seq"] for e in ref[1]["events"]] == [1, 2, 3]
    for path in ("/events?n=lots", "/controller", "/nope",
                 "/snapshot", "/profile"):
        mine, ref = _both_get(both, path)
        _same_shape(mine, ref)
    assert mine[1]["state"] == "idle"
    mine, ref = _both_get(both, "/snapshot")
    assert mine[1]["program_audit"] == []
    assert mine[1]["liveness"]["status"] == "starting"
    mine, ref = _both_get(both, "/controller")
    assert mine[0] == 404 and "no fleet controller" in mine[1]["error"]
    watchdog.get_watchdog().observe("srvtest", "f", [np.ones(2)])
    mine, ref = _both_get(both, "/metrics")
    assert mine[0] == ref[0] == 200
    assert mine[2]["Content-Type"] == ref[2]["Content-Type"]
    fams = ("jit_cache_hits_total", "jit_cache_misses_total",
            "jit_retraces_total", "xla_compiles_total",
            "xla_compile_seconds", "xla_compile_cache_events_total",
            "relaunch_to_first_step_seconds", "profile_captures_total")
    for body in (mine[1], ref[1]):
        for fam in fams:
            assert f"# HELP paddle_tpu_{fam} " in body, fam
    assert 'paddle_tpu_jit_cache_misses_total{site="srvtest"}' in mine[1]


def test_profile_answers(both, tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PROFILE_DIR", str(tmp_path))
    for q in ("steps=zero", "steps=-1", "steps=2&timeout=soon"):
        mine, ref = _both_get(both, f"/profile?{q}")
        _same_shape(mine, ref)
        assert mine[0] == 400
    caps = (xplane.default_capture(), jxplane.default_capture())
    try:
        mine, ref = _both_get(both, "/profile?steps=200&wait=0")
        _same_shape(mine, ref)
        assert mine[0] == 202 and mine[1]["status"] == "armed"
        mine, ref = _both_get(both, "/profile?steps=2")
        _same_shape(mine, ref)
        assert mine[0] == 409
        assert "one session at a time" in mine[1]["error"]
        mine, ref = _both_get(both, "/profile")
        assert mine[1]["state"] == ref[1]["state"] == "armed"
    finally:
        for cap in caps:
            with cap._lock:
                if cap.state != "idle":
                    cap._abort_locked("test over")
            cap.wait(30)
    assert all(cap.state == "idle" for cap in caps)


def test_profile_window_over_noted_steps(both, tmp_path, monkeypatch):
    """A ?steps=2 capture armed with wait=0, then the steps noted on this
    (the training) thread: the trace's start, its lead-in step, two
    spans; the summary names the train_step span."""
    monkeypatch.setenv("PADDLE_TPU_PROFILE_DIR", str(tmp_path))
    srv = both[0]
    code, body, _ = _get(srv.port, "/profile?steps=2&wait=0&timeout=60")
    assert code == 202
    for step in range(1, 5):
        server.note_step(step)
    doc = xplane.default_capture().wait(10)
    assert doc["status"] == "complete" and doc["steps"] == 2
    assert "train_step" in doc["summary_table"]
    assert doc["correlation"]["annotations"] == 2
    code, body, _ = _get(srv.port, "/profile")
    assert json.loads(body)["last"]["status"] == "complete"


def test_requests_and_slo_404_without_an_engine(both):
    for path in ("/requests", "/slo"):
        mine, ref = _both_get(both, path)
        _same_shape(mine, ref)
        assert mine[0] == 404
    code, body, _ = _post(both[0].port, "/generate", '{"prompt": [1]}')
    jcode, jbody, _ = _post(both[1].port, "/generate", '{"prompt": [1]}')
    assert code == jcode == 503
    assert json.loads(body) == json.loads(jbody)


def test_generate_gives_the_reference_tokens(both, engines):
    eng, jeng = engines("obs_gen", max_batch=1)
    mine, ref = _both_get(both, "/generate")
    _same_shape(mine, ref)
    assert mine[0] == 405
    rng = np.random.default_rng(5)
    for n, new in ((7, 3), (12, 5), (3, 4)):
        body = json.dumps({"prompt": rng.integers(1, 512, n).tolist(),
                           "max_new_tokens": new, "temperature": 0.0})
        outs = [_post(s.port, "/generate", body) for s in both]
        assert outs[0][0] == outs[1][0] == 200, outs
        a, b = (json.loads(o[1]) for o in outs)
        assert set(a) == set(b)
        assert a["tokens"] == b["tokens"] and len(a["tokens"]) == new
        assert a["model"] == "obs_gen"
        assert a["finish_reason"] == b["finish_reason"]
        assert a["e2e_s"] >= a["ttft_s"] >= 0
        assert eng.tracer.get(a["request"]).trace_id == a["trace_id"]
    mine, ref = _both_get(both, "/requests?n=5")
    _same_shape(mine, ref)
    assert len(mine[1]["completed"]) == len(ref[1]["completed"]) == 3
    mine, ref = _both_get(both, "/slo")
    _same_shape(mine, ref)
    assert mine[1]["signals"]["ttft"]["count"] == 3
    mine, ref = _both_get(both, "/requests?n=lots")
    _same_shape(mine, ref)
    assert mine[0] == 400


def test_generate_400_429_and_503_answers(both, engines, monkeypatch):
    eng, jeng = engines("obs_shed", max_batch=1)
    bodies = (b"{not json", json.dumps({"prompt": "hello"}),
              json.dumps({"prompt": [1, 2, 3], "temperature": -2.0}),
              json.dumps({"prompt": [1, 2], "model": "obs_nope"}))
    for body in bodies:
        outs = [_post(s.port, "/generate", body) for s in both]
        assert outs[0][0] == outs[1][0] and outs[0][0] in (400, 503)
        assert set(json.loads(outs[0][1])) == set(json.loads(outs[1][1]))
    # suspended: 503 with Retry-After
    for e in (eng, jeng):
        e.suspend(reason="memory_pressure", retry_after_s=4.0)
    body = json.dumps({"prompt": [1, 2, 3], "model": "obs_shed"})
    outs = [_post(s.port, "/generate", body) for s in both]
    for code, text, hdrs in outs:
        doc = json.loads(text)
        assert code == 503 and "memory_pressure" in doc["error"]
        assert doc["retry_after_s"] == 4.0 and hdrs["Retry-After"] == "4"
    assert set(json.loads(outs[0][1])) == set(json.loads(outs[1][1]))
    for e in (eng, jeng):
        e.resume_admissions()
    # the admission queue at its limit: 429
    monkeypatch.setenv("PADDLE_TPU_SERVING_QUEUE_LIMIT", "2")
    for e in (eng, jeng):
        for _ in range(2):
            e.submit(list(range(1, 6)), max_new_tokens=2)
    outs = [_post(s.port, "/generate", json.dumps({"prompt": [1, 2]}))
            for s in both]
    docs = [json.loads(o[1]) for o in outs]
    assert outs[0][0] == outs[1][0] == 429 and docs[0] == docs[1]
    assert docs[0]["queue_depth"] == 2 and docs[0]["limit"] == 2
    # wedged: work held past the stall threshold; /healthz says so too
    for e in (eng, jeng):
        monkeypatch.setattr(e, "_last_progress", e._last_progress - 3600.0)
    for s in both:
        monkeypatch.setattr(s, "stall_after", 1.0)
    outs = [_post(s.port, "/generate", json.dumps({"prompt": [1, 2]}))
            for s in both]
    docs = [json.loads(o[1]) for o in outs]
    assert outs[0][0] == outs[1][0] == 503 and docs[0] == docs[1]
    assert "wedged" in docs[0]["error"]
    mine, ref = _both_get(both, "/healthz")
    _same_shape(mine, ref)
    assert mine[0] == 503 and mine[1]["stalled_by"] == "serving:obs_shed"
    assert mine[1]["serving"] == ref[1]["serving"] | {
        "obs_shed": dict(ref[1]["serving"]["obs_shed"],
                         last_progress_age_s=mine[1]["serving"]["obs_shed"]
                         ["last_progress_age_s"])}
    for e in (eng, jeng):
        e.run_until_idle()
    mine, ref = _both_get(both, "/healthz")
    _same_shape(mine, ref)
    assert mine[1].get("stalled_by") is None


def test_maybe_start_server_and_the_fleet_refusals(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_METRICS_PORT", raising=False)
    assert server.maybe_start_server() is None
    monkeypatch.setenv("PADDLE_TPU_METRICS_PORT", "not-a-port")
    with pytest.warns(UserWarning, match="not a port"):
        assert server.maybe_start_server() is None
    monkeypatch.setenv("PADDLE_TPU_METRICS_PORT", "0")
    for kw in ({"role": "supervisor"}, {"aggregator": object()}):
        with pytest.raises(NotImplementedError, match="A11"):
            server.maybe_start_server(**kw)
    with pytest.raises(NotImplementedError, match="A11"):
        server.ObservabilityServer(aggregator=object())
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    with pytest.raises(NotImplementedError, match="FleetReporter"):
        server.maybe_start_server()
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    try:
        s1 = server.maybe_start_server()
        assert s1 is not None and s1.port
        assert server.maybe_start_server() is s1
        assert server.get_server() is s1
        code, body, _ = _get(s1.port, "/metrics")
        assert code == 200 and body.startswith("# HELP")
    finally:
        server.stop_server()
    assert server.get_server() is None
