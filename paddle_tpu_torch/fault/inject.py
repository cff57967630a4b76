"""Deterministic fault injection at named sites (a copy of
``paddle_tpu/fault/inject.py``; ``KNOWN_SITES`` lists only the sites
the port declares).

Instrumented code declares a site — `fault.site("store.get")` — which is a
no-op until armed.  Arming happens either programmatically
(`fault.configure("store.get", times=1)`) or via the
`PADDLE_TPU_FAULT_SPEC` environment variable, which spawned DataLoader
worker processes inherit, so a single spec string can fault any layer of a
training job.

Spec grammar (semicolon-separated clauses)::

    spec   := clause (';' clause)*
    clause := site '=' count ['@' start] [':' kind]
    kind   := 'error' | 'timeout' | 'oserror' | 'kill' | 'delay'

`count` occurrences are faulted starting at the `start`-th call of the
site (1-based, default 1).  Occurrences are counted per process.  Examples:

    store.get=2                 fail the first two store.get calls
    ps.pull_dense=1@3           fail only the third pull_dense RPC
    dataloader.worker0=1:kill   worker 0 os._exit()s on its first batch
    fleet.step=100:delay        slow this host's steps (straggler chaos)

`delay` raises nothing: it sleeps `PADDLE_TPU_FAULT_DELAY` seconds
(default 0.05) at the site — the "slow host, not dead host" failure mode
the fleet straggler detector exists for.

Every injected fault increments `fault_injected_total{site=,kind=}` in the
metrics registry AND lands one `fault_injected` event in the unified event
log, so a chaos run's recovery story is auditable from the prometheus/JSON
snapshot alongside the retry counters.
"""
from __future__ import annotations

import os
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Dict, Optional

from ..profiler import events as _events_mod
from ..profiler import metrics as _metrics_mod

SPEC_ENV = "PADDLE_TPU_FAULT_SPEC"

_REG = _metrics_mod.default_registry()
_M_INJECTED = _REG.counter(
    "fault_injected_total",
    "faults injected at instrumented sites, labeled by site and kind")


class InjectedFault(RuntimeError):
    """Raised by an armed fault site (kind=error)."""


class InjectedTimeout(TimeoutError):
    """Raised by an armed fault site (kind=timeout)."""


class InjectedIOError(OSError):
    """Raised by an armed fault site (kind=oserror)."""


class DeviceOOMError(RuntimeError):
    """Device memory exhausted (typed detection at the allocator boundary).

    Raised by the eager dispatch when XLA reports RESOURCE_EXHAUSTED / OOM
    for an op, or when the `device.alloc` fault site is armed — named so
    callers can catch the OOM specifically (shrink batch, flush caches)
    instead of pattern-matching XlaRuntimeError strings."""

    def __init__(self, op: str, bytes_estimate: int = 0, detail: str = ""):
        msg = f"device out of memory in op {op!r}"
        if bytes_estimate:
            msg += f" (~{bytes_estimate} bytes touched)"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)
        self.op = op
        self.bytes_estimate = int(bytes_estimate)


_KINDS = ("error", "timeout", "oserror", "kill", "delay")

#: Every fault site the port declares, with where it sits (the subset of
#: the reference's ``KNOWN_SITES`` whose code the port has).
KNOWN_SITES = {
    "serving.decode": "per-iteration serving decode dispatch "
                      "(latency chaos for SLO breach drills)",
    "serving.wedge": "top of the serving step loop "
                     "(delay kind wedges the decode loop for "
                     "watchdog-restart drills)",
    "serving.admit": "request admission into the serving queue "
                     "(shed and admission-failure drills)",
    "heter.pull": "heter-PS sparse pull stage",
    "heter.push": "heter-PS sparse push stage",
    "store.get": "TCPStore get (retry-wrapped)",
    "store.set": "TCPStore set (retry-wrapped)",
    "store.add": "TCPStore atomic add (retry-wrapped)",
    "store.check": "TCPStore key-presence check (retry-wrapped)",
    "parallel.init": "store rendezvous in init_parallel_env",
    "collective.timeout": "eager collective launch (guarded deadline)",
    "ckpt.commit": "coordinated-checkpoint commit phase",
}

#: dynamic site families: call sites build the name from a prefix + a
#: runtime suffix (the reference's DataLoader workers are not ported yet)
DYNAMIC_SITES: Dict[str, str] = {
    "ps.": "PS client RPC, by op (ps.pull_dense, ps.push_sparse, ...)",
}


@dataclass
class _Rule:
    count: int          # how many occurrences to fault
    start: int = 1      # 1-based first faulted occurrence
    kind: str = "error"
    fired: int = 0      # how many faults this rule has injected


def _parse_clause(clause: str) -> Optional[tuple]:
    site_name, sep, action = clause.partition("=")
    site_name = site_name.strip()
    if not sep or not site_name:
        return None
    action = action.strip()
    kind = "error"
    if ":" in action:
        action, kind = action.rsplit(":", 1)
        kind = kind.strip().lower()
        if kind not in _KINDS:
            return None
    start = 1
    if "@" in action:
        action, s = action.split("@", 1)
        start = int(s)
    count = int(action)
    if count < 0 or start < 1:
        return None
    return site_name, _Rule(count=count, start=start, kind=kind)


class FaultInjector:
    """Per-process registry of armed fault sites (thread-safe)."""

    def __init__(self, spec: Optional[str] = None):
        self._lock = threading.Lock()
        self._rules: Dict[str, _Rule] = {}
        self._seen: Dict[str, int] = {}
        if spec is None:
            spec = os.environ.get(SPEC_ENV, "")
        if spec:
            self.load_spec(spec)

    def load_spec(self, spec: str):
        """Parse and arm a spec string; malformed clauses warn, not crash —
        a typo in an env var must never take down a production job."""
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            try:
                parsed = _parse_clause(clause)
            except ValueError:
                parsed = None
            if parsed is None:
                warnings.warn(
                    f"{SPEC_ENV}: ignoring malformed clause {clause!r} "
                    f"(grammar: site=count[@start][:kind], kind in {_KINDS})")
                continue
            name, rule = parsed
            with self._lock:
                self._rules[name] = rule

    def configure(self, site: str, times: int = 1, start: int = 1,
                  kind: str = "error"):
        """Programmatic arming (tests): fault `times` occurrences of `site`
        starting at the `start`-th call."""
        if kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
        with self._lock:
            self._rules[site] = _Rule(count=times, start=start, kind=kind)

    def reset(self):
        """Disarm every site and zero occurrence counters."""
        with self._lock:
            self._rules.clear()
            self._seen.clear()

    def fired(self, site: str) -> int:
        """How many faults have been injected at `site` in this process."""
        with self._lock:
            rule = self._rules.get(site)
            return rule.fired if rule else 0

    def site(self, name: str):
        """Declare one occurrence of a fault site; injects if armed."""
        if not self._rules:
            # lock-free fast path: sites now sit on per-op hot paths (the
            # eager dispatch's allocator boundary, collective entry points),
            # and an unarmed injector must cost one dict truthiness check.
            # Arming happens-before the faulted call in every supported use
            # (env spec at import, configure() before the exercised code).
            return
        with self._lock:
            if not self._rules:
                return
            rule = self._rules.get(name)
            if rule is None:
                return
            n = self._seen.get(name, 0) + 1
            self._seen[name] = n
            if not (rule.start <= n < rule.start + rule.count):
                return
            rule.fired += 1
            kind = rule.kind
        if _metrics_mod.enabled():
            _M_INJECTED.inc(site=name, kind=kind)
        _events_mod.emit("fault_injected", severity="warn",
                         site=name, fault_kind=kind)
        if kind == "kill":
            # simulate a preemption / OOM-kill of this process: no cleanup,
            # no exception propagation — the parent sees a corpse
            os._exit(17)
        if kind == "delay":
            # slow, not dead: the straggler failure mode — nothing raises,
            # including on a garbled PADDLE_TPU_FAULT_DELAY (delay is legal
            # at ANY site; a ValueError escaping here would crash the op
            # with an error unrelated to the slow-host semantics)
            raw = os.environ.get("PADDLE_TPU_FAULT_DELAY", "0.05")
            try:
                delay = float(raw)
            except ValueError:
                warnings.warn(f"PADDLE_TPU_FAULT_DELAY={raw!r} is not a "
                              f"number; using 0.05s")
                delay = 0.05
            time.sleep(delay)
            return
        if kind == "timeout":
            raise InjectedTimeout(f"injected timeout at fault site {name!r}")
        if kind == "oserror":
            raise InjectedIOError(f"injected I/O error at fault site {name!r}")
        raise InjectedFault(f"injected fault at site {name!r}")


_default = FaultInjector()


def default_injector() -> FaultInjector:
    return _default


def site(name: str):
    """Module-level shorthand: `fault.site("store.get")`."""
    _default.site(name)


def configure(site_name: str, times: int = 1, start: int = 1,
              kind: str = "error"):
    _default.configure(site_name, times=times, start=start, kind=kind)


def reset():
    _default.reset()


def reload_spec():
    """Re-read PADDLE_TPU_FAULT_SPEC (after reset) — lets tests arm faults
    by mutating os.environ mid-process."""
    _default.reset()
    spec = os.environ.get(SPEC_ENV, "")
    if spec:
        _default.load_spec(spec)
