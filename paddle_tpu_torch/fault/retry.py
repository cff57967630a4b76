"""Bounded retry with exponential backoff + deterministic jitter (a copy of
``paddle_tpu/fault/retry.py``).

Reference: the reference PS stack retries at the brpc layer
(`brpc_ps_client.cc` FLAGS_pserver_timeout_ms / connect retries) and the
elastic manager re-registers etcd leases on transient failures.  Here one
policy object serves every distributed edge (TCPStore, PS RPC, checkpoint
I/O) so the knobs are uniform and every retry is visible in the metrics
registry (`retry_attempts_total{op=...}` / `retry_exhausted_total{op=...}`).

Jitter is drawn from a seeded PRNG private to the policy instance, so a
given policy replays the exact same backoff schedule run after run —
deterministic fault-injection tests stay deterministic end to end.
"""
from __future__ import annotations

import functools
import os
import time
from typing import Callable, Optional, Tuple, Type

from ..profiler import events as _events_mod
from ..profiler import metrics as _metrics_mod

_REG = _metrics_mod.default_registry()
_M_RETRIES = _REG.counter(
    "retry_attempts_total",
    "failed attempts that were retried, labeled by logical operation")
_M_EXHAUSTED = _REG.counter(
    "retry_exhausted_total",
    "operations that failed every attempt and gave up")
_M_RECOVERED = _REG.counter(
    "retry_recovered_total",
    "operations that succeeded after at least one retry")


class RetryExhaustedError(RuntimeError):
    """All attempts failed. Carries the op name and the last exception."""

    def __init__(self, op: str, attempts: int, last: BaseException):
        super().__init__(
            f"operation {op!r} failed after {attempts} attempt(s); "
            f"last error: {type(last).__name__}: {last}")
        self.op = op
        self.attempts = attempts
        self.last = last


class AttemptTimeout(TimeoutError):
    """A single attempt exceeded the policy's per-attempt timeout."""


class RetryPolicy:
    """Exponential backoff + jitter, per-attempt timeout, max attempts.

    delay(i) = min(max_delay, base_delay * 2**i) * (1 + jitter * u),
    u in [0, 1) from a PRNG seeded with `seed` — the schedule is
    reproducible for a given policy instance.

    `attempt_timeout` (seconds) bounds each attempt by running it on a
    worker thread; a timed-out attempt counts as a failure and is retried.
    The abandoned call keeps running on its thread until it returns — only
    use attempt_timeout with calls that are safe to abandon.
    """

    def __init__(self, max_attempts: int = 3, base_delay: float = 0.05,
                 max_delay: float = 2.0, jitter: float = 0.25,
                 attempt_timeout: Optional[float] = None,
                 retry_on: Tuple[Type[BaseException], ...] = (Exception,),
                 seed: int = 0):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self.attempt_timeout = attempt_timeout
        self.retry_on = retry_on
        self.seed = int(seed)
        import random
        self._rng = random.Random(self.seed)

    @classmethod
    def from_env(cls, prefix: str, **defaults) -> "RetryPolicy":
        """Build a policy from PADDLE_TPU_<PREFIX>_{RETRIES,BACKOFF,TIMEOUT}
        env knobs, falling back to `defaults` then class defaults."""
        from ..utils import envparse
        env = os.environ
        p = f"PADDLE_TPU_{prefix.upper()}_"
        # garbled knob values warn + keep the caller's default (shared
        # envparse contract) — a typo'd PADDLE_TPU_STORE_RETRIES must not
        # detonate as an anonymous ValueError at TCPStore construction
        if p + "RETRIES" in env:
            defaults["max_attempts"] = envparse.env_int(
                p + "RETRIES", defaults.get("max_attempts", 3))
        if p + "BACKOFF" in env:
            defaults["base_delay"] = envparse.env_float(
                p + "BACKOFF", defaults.get("base_delay", 0.05))
        if p + "TIMEOUT" in env:
            t = envparse.env_float(p + "TIMEOUT", 0.0)
            defaults["attempt_timeout"] = t if t > 0 else None
        return cls(**defaults)

    def delay(self, attempt: int) -> float:
        """Backoff before retry number `attempt` (0-based)."""
        base = min(self.max_delay, self.base_delay * (2.0 ** attempt))
        return base * (1.0 + self.jitter * self._rng.random())

    def _run_once(self, fn: Callable, args, kw):
        if self.attempt_timeout is None:
            return fn(*args, **kw)
        import threading
        box: dict = {}

        def runner():
            try:
                box["result"] = fn(*args, **kw)
            except BaseException as e:
                box["error"] = e

        # a daemon thread, NOT an executor: abandoned attempts must neither
        # block the next attempt nor pin interpreter exit (3.9+ executor
        # threads are joined at shutdown)
        t = threading.Thread(target=runner, daemon=True)
        t.start()
        t.join(self.attempt_timeout)
        if t.is_alive():
            raise AttemptTimeout(
                f"attempt exceeded {self.attempt_timeout}s")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def call(self, fn: Callable, *args, op: Optional[str] = None, **kw):
        """Run `fn(*args, **kw)` under this policy; raises
        RetryExhaustedError after the last attempt fails."""
        name = op or getattr(fn, "__name__", "call")
        last: Optional[BaseException] = None
        record = _metrics_mod.enabled()
        for attempt in range(self.max_attempts):
            try:
                result = self._run_once(fn, args, kw)
                if attempt > 0:
                    if record:
                        _M_RECOVERED.inc(op=name)
                    _events_mod.emit("retry_recovered", op=name,
                                     attempts=attempt + 1)
                return result
            except self.retry_on as e:
                last = e
                if attempt + 1 >= self.max_attempts:
                    break
                if record:
                    _M_RETRIES.inc(op=name)
                time.sleep(self.delay(attempt))
        if record:
            _M_EXHAUSTED.inc(op=name)
        _events_mod.emit("retry_exhausted", severity="error", op=name,
                         attempts=self.max_attempts,
                         error=f"{type(last).__name__}: {last}")
        raise RetryExhaustedError(name, self.max_attempts, last)

    def wrap(self, op: Optional[str] = None):
        """Decorator form: @policy.wrap("store.get")."""
        def deco(fn):
            @functools.wraps(fn)
            def inner(*args, **kw):
                return self.call(fn, *args, op=op or fn.__name__, **kw)
            return inner
        return deco


def retry_call(fn: Callable, *args, policy: Optional[RetryPolicy] = None,
               op: Optional[str] = None, **kw):
    """One-shot helper: retry `fn` under `policy` (default RetryPolicy())."""
    return (policy or RetryPolicy()).call(fn, *args, op=op, **kw)


def retryable(op: Optional[str] = None,
              policy: Optional[RetryPolicy] = None):
    """Decorator: @retryable("ps.pull_dense", policy=...)."""
    return (policy or RetryPolicy()).wrap(op)
