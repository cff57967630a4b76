"""Budget-based graceful degradation for co-resident serving engines
(counterpart of ``paddle_tpu/inference/governor.py``).

Several models share one card (multi-model `/generate` routing); the
chip does not care which one OOMs it. :class:`MemoryGovernor` is the
arbiter: it samples the card's memory in use (``total - free`` from
``torch.cuda.mem_get_info``: the caching allocator, the captured graphs'
pools and everything else on the card, as an out-of-memory failure would
count them) and, when in-use bytes cross the
configured limit, degrades the LOWEST-priority engine down a two-rung
ladder instead of letting allocation fail mid-decode:

1. **shrink** — park half the engine's free KV pages out of circulation
   (``ServingEngine.shrink_pool``): admission slows, decode continues;
2. **suspend** — refuse new admissions entirely
   (``ServingEngine.suspend``): `/generate` answers 503 with a
   Retry-After header while in-flight work drains.

When pressure clears (with hysteresis — below ``resume_frac`` of the
limit), engines recover in REVERSE priority order: suspended engines
resume first, then parked pages return. Every rung is one
``controller_decision`` event (policy ``serving_memory``), so the
degradation trail reads like any other controller action.

Knobs: ``PADDLE_TPU_SERVING_MEM_LIMIT_BYTES`` (0 = governor inert),
``PADDLE_TPU_SERVING_RETRY_AFTER_SEC`` (the 503 Retry-After hint).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, List, Optional

import torch

from ..profiler import events as _events
from ..utils.envparse import env_float, env_int
from .serving import ServingEngine, live_engines

__all__ = ["MemoryGovernor"]


class MemoryGovernor:
    """Drive with `tick()` (the serving host's poll loop, or a test).
    `sampler` overrides the in-use-bytes source (default: ``total -
    free`` of each card the engines run on, or the engines' summed
    page-pool footprints when none runs on a card)."""

    def __init__(self, limit_bytes: Optional[int] = None,
                 sampler: Optional[Callable[[], int]] = None,
                 engines: Optional[Callable[[], List[ServingEngine]]] = None,
                 retry_after_s: Optional[float] = None,
                 resume_frac: float = 0.85):
        self.limit_bytes = (env_int("PADDLE_TPU_SERVING_MEM_LIMIT_BYTES", 0)
                            if limit_bytes is None else int(limit_bytes))
        self.retry_after_s = (env_float("PADDLE_TPU_SERVING_RETRY_AFTER_SEC",
                                        5.0)
                              if retry_after_s is None
                              else float(retry_after_s))
        self.resume_frac = float(resume_frac)
        self._sampler = sampler
        self._engines = engines if engines is not None else live_engines
        #: engines this governor degraded, name -> rung ("shrunk"|
        #: "suspended") — only its own actions are ever undone
        self._degraded: dict = {}
        self.decisions: "deque[dict]" = deque(maxlen=64)

    # -- sampling -------------------------------------------------------------
    def in_use_bytes(self, engines: List[ServingEngine]) -> int:
        if self._sampler is not None:
            return int(self._sampler())
        cards = {e.device.index if e.device.index is not None
                 else torch.cuda.current_device()
                 for e in engines if e.device.type == "cuda"}
        if cards:
            total = 0
            for dev in cards:
                free, size = torch.cuda.mem_get_info(dev)
                total += size - free
            return total
        return sum(e.pool_bytes() for e in engines)

    # -- the control loop -----------------------------------------------------
    def tick(self) -> Optional[dict]:
        """One observe→decide→act pass. Returns the decision record when
        an action was taken (None = steady state)."""
        if self.limit_bytes <= 0:
            return None
        engines = [e for e in self._engines() if not e._closed]
        if not engines:
            return None
        in_use = self.in_use_bytes(engines)
        if in_use > self.limit_bytes:
            return self._degrade(engines, in_use)
        if self._degraded and in_use < self.limit_bytes * self.resume_frac:
            return self._recover(engines, in_use)
        return None

    def _decide(self, action: str, eng: ServingEngine, in_use: int,
                **extra) -> dict:
        rec = {"ts": time.time(), "policy": "serving_memory",
               "action": action, "model": eng.name,
               "priority": eng.priority, "in_use_bytes": int(in_use),
               "limit_bytes": self.limit_bytes, "outcome": "applied"}
        rec.update(extra)
        self.decisions.append(rec)
        _events.emit("controller_decision", **rec)
        return rec

    def _degrade(self, engines: List[ServingEngine], in_use: int
                 ) -> Optional[dict]:
        # lowest priority first; never below the highest-priority engine
        # (someone must keep serving), ties broken newest-first
        order = sorted(enumerate(engines),
                       key=lambda ie: (ie[1].priority, -ie[0]))
        for _, eng in order:
            rung = self._degraded.get(eng.name)
            if rung is None:
                parked = eng.shrink_pool()
                self._degraded[eng.name] = "shrunk"
                return self._decide("shrink_pool", eng, in_use,
                                    parked_pages=parked)
            if rung == "shrunk":
                eng.suspend(reason="memory_pressure",
                            retry_after_s=self.retry_after_s)
                self._degraded[eng.name] = "suspended"
                return self._decide("suspend", eng, in_use,
                                    retry_after_s=self.retry_after_s)
        return None  # every engine already fully degraded

    def _recover(self, engines: List[ServingEngine], in_use: int
                 ) -> Optional[dict]:
        by_name = {e.name: e for e in engines}
        # undo the deepest rung on the HIGHEST-priority degraded engine
        for name, rung in sorted(
                self._degraded.items(),
                key=lambda kv: -by_name[kv[0]].priority
                if kv[0] in by_name else 0):
            eng = by_name.get(name)
            if eng is None:
                self._degraded.pop(name, None)
                continue
            if rung == "suspended":
                eng.resume_admissions()
                self._degraded[name] = "shrunk"
                return self._decide("resume", eng, in_use)
            restored = eng.restore_pool()
            self._degraded.pop(name, None)
            return self._decide("restore_pool", eng, in_use,
                                restored_pages=restored)
        return None

    def status(self) -> dict:
        return {"limit_bytes": self.limit_bytes,
                "degraded": dict(self._degraded),
                "decisions": list(self.decisions)[-8:]}
