"""paddle_tpu_torch.fault — fault-tolerance primitives (a copy of
``paddle_tpu/fault/``: the port imports nothing of the JAX package).

Two halves, used together across the runtime:

* `RetryPolicy` / `retry_call` / `retryable` — bounded exponential backoff
  with deterministic jitter and optional per-attempt timeout.  The TCPStore,
  PS client, and checkpoint manager all retry through this, and every retry
  lands in the metrics registry (`retry_attempts_total{op=...}`).
* `FaultInjector` / `site` — deterministic fault injection at named sites,
  armed by `PADDLE_TPU_FAULT_SPEC` or `fault.configure(...)`.  Injected
  faults are counted in `fault_injected_total{site=,kind=}`.

Together they make recovery *provable*: a chaos test arms a spec, runs
training, and asserts from the metrics snapshot that the faults fired and
were retried/recovered.
"""
from .inject import (  # noqa: F401
    SPEC_ENV, DeviceOOMError, FaultInjector, InjectedFault, InjectedIOError,
    InjectedTimeout, configure, default_injector, reload_spec, reset, site,
)
from .retry import (  # noqa: F401
    AttemptTimeout, RetryExhaustedError, RetryPolicy, retry_call, retryable,
)

__all__ = [
    "AttemptTimeout", "DeviceOOMError", "FaultInjector", "InjectedFault",
    "InjectedIOError", "InjectedTimeout", "RetryExhaustedError",
    "RetryPolicy", "SPEC_ENV", "configure", "default_injector",
    "reload_spec", "reset", "retry_call", "retryable", "site",
]
