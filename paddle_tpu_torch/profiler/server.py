"""ObservabilityServer: the runtime's HTTP face — /metrics /snapshot
/healthz /events /profile /requests /slo /generate on a stdlib
daemon-thread server (counterpart of ``paddle_tpu/profiler/server.py``:
the same endpoints, status codes and JSON keys).

This serves the process-wide surfaces over plain HTTP (http.server, zero
deps):

    /metrics    Prometheus text from the default registry
    /snapshot   one JSON object: metrics snapshot, watchdog snapshot (incl.
                compile attribution), liveness, recent events
    /healthz    step liveness: 200 {"status": "healthy"} while steps keep
                arriving, 503 {"status": "stalled"} once the last observed
                step is older than PADDLE_TPU_HEALTH_STALL_SEC (default
                300; "starting" before the first step)
    /events     recent unified-event-log entries (?kind=...&n=...)
    /profile    on-demand deep profiling: ?steps=N arms a bounded capture
                window around the next N train steps (torch.profiler trace
                + host spans, correlated by profiler/xplane.py) and returns
                the session summary; 409 while a session is in flight,
                hard wall-clock cap PADDLE_TPU_PROFILE_TIMEOUT
    /controller 404: no fleet controller runs in the port's processes
                (the fleet plane is ROADMAP A11/A12)
    /requests   serving introspection: live + recently-completed request
                traces (per-request phase breakdown from
                profiler/reqtrace.py) and the engine's per-iteration
                snapshot ring; 404 when no engine runs in this process
    /slo        serving SLO plane (profiler/slo.py): targets, sliding-
                window p50/p95/p99 per signal, current breach status
    /generate   POST {"prompt": [token ids], "max_new_tokens": N,
                sampling knobs...} -> generated tokens + latency
                attribution from the live engine. Sheds instead of
                hanging: 503 JSON when the engine is wedged past the
                /healthz stall threshold (or closed/absent), 429 with
                the queue depth when admission is saturated

Opt-in: set `PADDLE_TPU_METRICS_PORT` (0 = pick a free port) and
`Model.fit` auto-starts it. The fleet pieces of the reference — the
FleetReporter / FleetAggregator (an explicit ``aggregator=``, or a trainer
env of ``PADDLE_TRAINERS_NUM`` >= 2) and ``role="supervisor"`` — raise,
naming ROADMAP A11/A12, until the fleet plane is ported.

Liveness is fed by `note_step()`, called by the fit loop and
ThroughputMonitor; the first note also publishes
`relaunch_to_first_step_seconds`, and every note drives an armed
`/profile` capture.
"""
from __future__ import annotations

import json
import os
import threading
import time
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ..utils.envparse import env_float, env_int
from . import compile_watch as _compile_watch
from . import events as _events_mod
from . import health as _health_mod
from . import metrics as _metrics_mod
from . import xplane as _xplane_mod
from .watchdog import get_watchdog

__all__ = ["ObservabilityServer", "maybe_start_server", "note_step",
           "liveness", "get_server", "stop_server"]

DEFAULT_STALL_SEC = 300.0

# module-level liveness: {step, ts(monotonic), wall_ts}
_liveness_lock = threading.Lock()
_liveness = {"step": None, "ts": None, "wall_ts": None}
_server: Optional["ObservabilityServer"] = None


def note_step(step: int):
    """Record train-loop progress. Cheap, idempotent per step index (a
    second caller reporting the same step is ignored; a SMALLER step means
    a new training run started in this process), and never raises."""
    global _liveness
    step = int(step)
    with _liveness_lock:
        last = _liveness["step"]
        if last is not None and step == last:
            return  # a second caller reporting the same step
        first = last is None
        # step < last means a NEW training run in this process (a fresh
        # fit, an in-process elastic re-entry): liveness follows it
        _liveness["step"] = step
        _liveness["ts"] = time.monotonic()
        _liveness["wall_ts"] = time.time()
    if first:
        _compile_watch.note_first_step()
    # drive any armed /profile capture window (cheap no-op while idle;
    # on_step itself never raises)
    _xplane_mod.default_capture().on_step(step)


def liveness(stall_after: Optional[float] = None) -> dict:
    """{"status": healthy|stalled|starting, "last_step", "last_step_age_s",
    "stall_after_s"} — the /healthz payload."""
    if stall_after is None:
        stall_after = env_float("PADDLE_TPU_HEALTH_STALL_SEC",
                                DEFAULT_STALL_SEC)
    with _liveness_lock:
        step, ts = _liveness["step"], _liveness["ts"]
    if step is None:
        return {"status": "starting", "last_step": None,
                "last_step_age_s": None, "stall_after_s": stall_after}
    age = time.monotonic() - ts
    return {"status": "stalled" if age > stall_after else "healthy",
            "last_step": step, "last_step_age_s": round(age, 3),
            "stall_after_s": stall_after}


def _no_fleet(what: str):
    raise NotImplementedError(
        f"{what}: the fleet plane (FleetReporter, FleetAggregator, the "
        f"supervisor's server and controller) is not ported yet (ROADMAP "
        f"A11/A12)")


class ObservabilityServer:
    """One ThreadingHTTPServer on a daemon thread, serving this process.

    `aggregator` (the reference's fleet.telemetry.FleetAggregator) raises:
    the fleet plane is ROADMAP A11/A12."""

    def __init__(self, registry=None, aggregator=None,
                 stall_after: Optional[float] = None):
        if aggregator is not None:
            _no_fleet("ObservabilityServer(aggregator=...)")
        self.registry = registry or _metrics_mod.default_registry()
        self.stall_after = stall_after
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    # -- endpoint payloads ---------------------------------------------------
    def metrics_text(self) -> str:
        return self.registry.to_prometheus_text()

    def snapshot(self) -> dict:
        """One JSON blob for dashboards: metrics + watchdog + compile
        attribution + liveness + health + the events tail. The static
        program audit is ROADMAP A13: ``program_audit`` is ``[]``."""
        # refresh the device-memory gauges so the snapshot's watermark is
        # scrape-time, not last-step-record time
        _metrics_mod.update_device_memory_gauges(self.registry)
        snap = {
            "metrics": self.registry.snapshot(),
            "watchdog": get_watchdog().snapshot(),
            "compile_attribution": _compile_watch.summary(),
            "liveness": liveness(self.stall_after),
            "health": _health_mod.snapshot(),
            "events_tail": _events_mod.recent(50),
            "program_audit": [],
            "ts": time.time(),
        }
        return snap

    def profile(self, query: dict) -> (int, dict):
        """The `/profile` endpoint body: (http status, payload).

        `?steps=N` arms an on-demand capture around the next N train steps
        and (by default) blocks until it finalizes — one curl profiles a
        live job with zero restarts. Exactly one session at a time
        (concurrent requests get 409); the hard wall-clock cap
        (`PADDLE_TPU_PROFILE_TIMEOUT`, `&timeout=S` to shrink it) bounds
        the block even when the job is stalled. `&wait=0` returns the
        armed ack immediately; without `steps` the current/last session
        status is returned."""
        cap = _xplane_mod.default_capture()
        raw_steps = query.get("steps", [None])[0]
        if raw_steps is None:
            return 200, cap.status()
        try:
            steps = int(raw_steps)
            if steps < 1:
                raise ValueError
        except ValueError:
            return 400, {"error": f"steps={raw_steps!r} must be a "
                                  f"positive integer"}
        timeout_s = None
        raw_timeout = query.get("timeout", [None])[0]
        if raw_timeout is not None:
            try:
                timeout_s = float(raw_timeout)
            except ValueError:
                return 400, {"error": f"timeout={raw_timeout!r} must be "
                                      f"a number of seconds"}
        wait = query.get("wait", ["1"])[0] not in ("0", "false", "no")
        try:
            ack = cap.arm(steps, timeout_s=timeout_s)
        except _xplane_mod.CaptureBusyError as e:
            return 409, {"error": str(e), "status": cap.status()}
        if not wait:
            return 202, ack
        # the timer finalizes at the cap no matter what, so this bound is
        # a backstop against a wedged finalize, not the real limit
        summary = cap.wait((timeout_s or _xplane_mod.capture_timeout()) + 30)
        if summary is None:
            return 504, {"error": "capture did not finalize in time",
                         "status": cap.status()}
        return 200, summary

    def controller_status(self) -> (int, dict):
        """The `/controller` endpoint: 404, as the reference answers when no
        controller is attached to the process (the fleet controller is
        ROADMAP A12)."""
        return 404, {"error": "no fleet controller attached to this "
                              "process (the fleet controller is not "
                              "ported: ROADMAP A12)"}

    # -- serving introspection endpoints -------------------------------------
    @staticmethod
    def _engine(name: Optional[str] = None):
        """The live ServingEngine, WITHOUT importing the inference stack
        from a scrape: if serving was never imported in this process there
        is no engine to find."""
        import sys
        mod = sys.modules.get("paddle_tpu_torch.inference.serving")
        if mod is None:
            return None
        try:
            return mod.current_engine(name)
        except Exception:
            return None

    def requests_payload(self, query: dict) -> (int, dict):
        """`/requests`: live + recently-completed per-request phase
        breakdowns and the engine's per-iteration introspection ring."""
        raw_n = query.get("n", ["50"])[0]
        try:
            n = int(raw_n)
        except ValueError:
            return 400, {"error": f"n={raw_n!r} must be an integer"}
        eng = self._engine(query.get("model", [None])[0])
        if eng is None:
            return 404, {"error": "no serving engine in this process"}
        return 200, eng.requests_snapshot(n)

    def slo_payload(self, query: dict) -> (int, dict):
        """`/slo`: targets, sliding-window quantiles per signal, breach
        status. Falls back to the process's most recent SLO tracker when
        the engine itself is gone (post-close scrape)."""
        eng = self._engine(query.get("model", [None])[0])
        if eng is not None:
            return 200, eng.slo.snapshot()
        from .slo import current_snapshot
        snap = current_snapshot()
        if snap is None:
            return 404, {"error": "no serving SLO tracker in this "
                                  "process"}
        return 200, snap

    def generate_payload(self, body: bytes) -> (int, dict):
        """`/generate` (POST): one-call HTTP inference against the live
        engine. Routes by the optional `model` body field when several
        engines share the process. Sheds instead of hanging: 503 with a
        JSON error when the engine is wedged past the /healthz stall
        threshold (or closed / absent / suspended — suspended answers
        carry `retry_after_s`, surfaced as a Retry-After header), 429
        with the queue depth when admission is saturated
        (`PADDLE_TPU_SERVING_QUEUE_LIMIT` deep)."""
        try:
            req = json.loads(body.decode() or "{}")
        except (ValueError, UnicodeDecodeError) as e:
            req = None  # defer the 400: absent-engine 503 wins
        model = req.get("model") if isinstance(req, dict) else None
        eng = self._engine(model)
        if eng is None:
            if model is not None:
                return 503, {"error": f"no serving engine named "
                                      f"{model!r} in this process",
                             "model": model}
            return 503, {"error": "no serving engine in this process"}
        if req is None:
            return 400, {"error": "request body is not JSON"}
        if eng._closed:
            return 503, {"error": "serving engine is closed",
                         "model": eng.name}
        if eng.wedged(self.stall_after):
            return 503, {"error": "serving engine is wedged (no decode "
                                  "progress past the stall threshold)",
                         "model": eng.name,
                         "stall_after_s": self.stall_after or liveness()
                         .get("stall_after_s")}
        if getattr(eng, "_suspended", None):
            return 503, {"error": "serving engine is suspended "
                                  f"({eng._suspended.get('reason')})",
                         "model": eng.name,
                         "retry_after_s":
                             eng._suspended.get("retry_after_s")}
        limit = env_int("PADDLE_TPU_SERVING_QUEUE_LIMIT", 64)
        depth = eng.queue_depth()
        if limit > 0 and depth >= limit:
            return 429, {"error": "admission queue saturated",
                         "model": eng.name, "queue_depth": depth,
                         "limit": limit}
        prompt = req.get("prompt")
        if not isinstance(prompt, list) or \
                not all(isinstance(t, int) for t in prompt):
            return 400, {"error": "'prompt' must be a list of token ids"}
        sampling = None
        sp_keys = {k: req[k] for k in ("temperature", "top_k", "top_p",
                                       "seed") if k in req}
        if sp_keys:
            try:
                from ..inference.sampling import SamplingParams
                sampling = SamplingParams(**sp_keys)
            except (TypeError, ValueError) as e:
                return 400, {"error": f"bad sampling params: {e}"}
        try:
            out = eng.generate(
                prompt,
                max_new_tokens=int(req.get("max_new_tokens", 16)),
                sampling=sampling,
                timeout=float(req.get("timeout", 120.0)))
        except (TypeError, ValueError) as e:
            return 400, {"error": str(e)}
        except TimeoutError as e:
            return 504, {"error": str(e)}
        except RuntimeError as e:
            payload = {"error": str(e), "model": eng.name}
            if getattr(e, "retry_after_s", None) is not None:
                payload["retry_after_s"] = e.retry_after_s
            return 503, payload
        return 200, out

    def healthz(self) -> dict:
        h = liveness(self.stall_after)
        # serving liveness counts too: a running engine holding work
        # without a completed decode iteration inside the stall window
        # flips 503 `stalled` just like a training loop that stopped
        # stepping (lazy module lookup — never imports the inference
        # stack from a scrape)
        import sys
        mod = sys.modules.get("paddle_tpu_torch.inference.serving")
        if mod is not None:
            try:
                serving = {}
                for eng in mod.live_engines():
                    wedged = eng.wedged(self.stall_after)
                    serving[eng.name] = {
                        "pending": eng.pending(),
                        "last_progress_age_s":
                            round(eng.last_progress_age(), 3),
                        "wedged": wedged,
                        "suspended": bool(eng._suspended)}
                    if wedged:
                        h["status"] = "stalled"
                        h["stalled_by"] = h.get("stalled_by",
                                                "serving:" + eng.name)
                if serving:
                    h["serving"] = serving
            except Exception:
                pass
        return h

    # -- lifecycle -----------------------------------------------------------
    def start(self, port: int = 0, host: str = "") -> int:
        """Bind and serve on a daemon thread; returns the bound port."""
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # keep training stdout clean
                pass

            def _send(self, code: int, body: str, ctype: str,
                      headers: Optional[dict] = None):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                url = urlparse(self.path)
                try:
                    if url.path == "/metrics":
                        self._send(200, srv.metrics_text(),
                                   "text/plain; version=0.0.4")
                    elif url.path == "/snapshot":
                        self._send(200, json.dumps(srv.snapshot()),
                                   "application/json")
                    elif url.path == "/healthz":
                        h = srv.healthz()
                        self._send(200 if h["status"] != "stalled" else 503,
                                   json.dumps(h), "application/json")
                    elif url.path == "/events":
                        q = parse_qs(url.query)
                        try:
                            n = int(q.get("n", ["100"])[0])
                        except ValueError:
                            self._send(400, json.dumps(
                                {"error": f"n={q.get('n')[0]!r} must be "
                                          f"an integer"}),
                                "application/json")
                            return
                        kind = q.get("kind", [None])[0]
                        self._send(200, json.dumps(
                            {"events": _events_mod.recent(n, kind=kind)}),
                            "application/json")
                    elif url.path == "/profile":
                        code, payload = srv.profile(parse_qs(url.query))
                        self._send(code, json.dumps(payload),
                                   "application/json")
                    elif url.path == "/controller":
                        code, payload = srv.controller_status()
                        self._send(code, json.dumps(payload),
                                   "application/json")
                    elif url.path == "/requests":
                        code, payload = srv.requests_payload(
                            parse_qs(url.query))
                        self._send(code, json.dumps(payload),
                                   "application/json")
                    elif url.path == "/slo":
                        code, payload = srv.slo_payload(parse_qs(url.query))
                        self._send(code, json.dumps(payload),
                                   "application/json")
                    elif url.path == "/generate":
                        self._send(405, json.dumps(
                            {"error": "POST a JSON body "
                                      "{\"prompt\": [token ids], ...} "
                                      "to /generate"}),
                            "application/json")
                    else:
                        self._send(404, json.dumps(
                            {"error": "unknown path", "endpoints":
                             ["/metrics", "/snapshot", "/healthz",
                              "/events", "/profile", "/controller",
                              "/requests", "/slo", "/generate"]}),
                            "application/json")
                except BrokenPipeError:
                    pass
                except Exception as e:  # a handler bug must not kill a scrape
                    try:
                        self._send(500, json.dumps(
                            {"error": f"{type(e).__name__}: {e}"}),
                            "application/json")
                    except Exception:
                        pass

            def do_POST(self):
                url = urlparse(self.path)
                try:
                    if url.path == "/generate":
                        try:
                            length = int(self.headers.get(
                                "Content-Length", "0"))
                        except ValueError:
                            length = 0
                        body = self.rfile.read(length) if length else b""
                        code, payload = srv.generate_payload(body)
                        hdrs = None
                        if code == 503 and isinstance(payload, dict) and \
                                payload.get("retry_after_s") is not None:
                            hdrs = {"Retry-After": int(round(
                                float(payload["retry_after_s"])))}
                        self._send(code, json.dumps(payload),
                                   "application/json", headers=hdrs)
                    else:
                        self._send(404, json.dumps(
                            {"error": "unknown path", "endpoints":
                             ["/generate"]}), "application/json")
                except BrokenPipeError:
                    pass
                except Exception as e:  # a handler bug must not kill serving
                    try:
                        self._send(500, json.dumps(
                            {"error": f"{type(e).__name__}: {e}"}),
                            "application/json")
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name=f"obs-server:{self.port}")
        self._thread.start()
        return self.port

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self._thread = None


def get_server() -> Optional[ObservabilityServer]:
    return _server


def stop_server():
    global _server
    if _server is not None:
        _server.stop()
        _server = None


def maybe_start_server(role: str = "trainer",
                       aggregator=None) -> Optional[ObservabilityServer]:
    """Start the process-wide server if `PADDLE_TPU_METRICS_PORT` is set
    (idempotent; returns the existing server on repeat calls).

    role="trainer" (Model.fit) binds the configured port. The reference's
    fleet wiring raises, naming ROADMAP A11/A12: role="supervisor", an
    explicit `aggregator`, and a trainer env of PADDLE_TRAINERS_NUM >= 2
    (where the reference installs a FleetReporter on every rank and a
    FleetAggregator on rank 0). A port that cannot bind warns and leaves
    the server off, as in the reference."""
    global _server
    if _server is not None:
        return _server
    raw = os.environ.get("PADDLE_TPU_METRICS_PORT", "")
    if raw == "":
        return None
    try:
        port = int(raw)
    except ValueError:
        warnings.warn(f"PADDLE_TPU_METRICS_PORT={raw!r} is not a port "
                      f"number; observability server disabled")
        return None
    if role != "trainer":
        _no_fleet(f"maybe_start_server(role={role!r})")
    if aggregator is not None:
        _no_fleet("maybe_start_server(aggregator=...)")
    if env_int("PADDLE_TRAINERS_NUM", 1) >= 2:
        _no_fleet("maybe_start_server with PADDLE_TRAINERS_NUM >= 2 (the "
                  "FleetReporter / FleetAggregator)")
    server = ObservabilityServer()
    try:
        bound = server.start(port)
    except OSError as e:
        warnings.warn(f"observability server could not bind port {port}: "
                      f"{e}; disabled for this process")
        return None
    _server = server
    import logging
    logging.getLogger("paddle_tpu_torch.observability").info(
        "observability server (%s) on :%d — /metrics /snapshot /healthz "
        "/events", role, bound)
    return server
