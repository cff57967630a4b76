"""TCPStore — blocking key-value rendezvous store (counterpart of
``paddle_tpu/distributed/store.py``).

The reference's face over its native store server. Here it is a face
over ``torch.distributed.TCPStore``: torch's process groups rendezvous
on the same kind of store, so one server (hosted by rank 0 in
``init_parallel_env``) serves the process groups and the checkpoint
coordinator, and the port needs no C++ server of its own.

The master hosts the server in-process; every rank (master included)
is a client. ``port=0`` on the master binds a free port (``.port``).

get/set/add/check run under a bounded retry+backoff policy (knobs:
``PADDLE_TPU_STORE_RETRIES`` / ``PADDLE_TPU_STORE_BACKOFF``, or pass
``retry=RetryPolicy(...)``), and each declares a fault site
(``store.get`` etc.) for chaos tests. ``add`` retried is at-least-once.
"""
from __future__ import annotations

import datetime
from typing import List, Optional

import torch.distributed as dist

from ..fault import RetryPolicy
from ..fault import site as _fault_site


class TCPStore:
    def __init__(self, host: str, port: int, is_master: bool = False,
                 world_size: int = 1, timeout: int = 120,
                 retry: Optional[RetryPolicy] = None):
        self._retry = retry or RetryPolicy.from_env(
            "STORE", max_attempts=3, base_delay=0.05, max_delay=1.0)
        self._timeout = datetime.timedelta(seconds=float(timeout))
        try:
            # the master does not wait for the others to connect: the
            # reference's server does not count its clients either
            self._store = dist.TCPStore(
                host, int(port), int(world_size), bool(is_master),
                timeout=self._timeout, wait_for_workers=False)
        except Exception as e:
            what = "bind" if is_master else "connect"
            raise RuntimeError(f"TCPStore: cannot {what} {host}:{port}: "
                               f"{e}") from e
        self._port = int(self._store.port)
        self._is_master = bool(is_master)

    @property
    def port(self) -> int:
        return self._port

    @property
    def torch_store(self) -> dist.Store:
        """The underlying ``torch.distributed.TCPStore`` (what
        ``init_process_group(store=...)`` takes)."""
        return self._live()

    def _live(self) -> dist.Store:
        if self._store is None:
            raise RuntimeError("TCPStore: stopped")
        return self._store

    def set(self, key: str, value):
        if isinstance(value, str):
            value = value.encode()

        def _do():
            _fault_site("store.set")
            self._live().set(key, value)
        self._retry.call(_do, op="store.set")

    def get(self, key: str) -> bytes:
        """The value of ``key``, waiting (up to the store's timeout) for
        it to be set."""
        def _do():
            _fault_site("store.get")
            return bytes(self._live().get(key))
        return self._retry.call(_do, op="store.get")

    def add(self, key: str, delta: int) -> int:
        def _do():
            _fault_site("store.add")
            return int(self._live().add(key, int(delta)))
        return self._retry.call(_do, op="store.add")

    def wait(self, keys: List[str]):
        try:
            self._live().wait(list(keys))
        except Exception as e:
            raise RuntimeError(f"TCPStore.wait failed: {e}") from e

    def check(self, key: str) -> bool:
        # retried like get/set/add: the coordinated-checkpoint barrier
        # polls through check(), and a transient master hiccup mid-poll
        # must cost a backoff, not a fleet-wide checkpoint abort
        def _do():
            _fault_site("store.check")
            return bool(self._live().check([key]))
        return self._retry.call(_do, op="store.check")

    def delete_key(self, key: str):
        try:
            self._live().delete_key(key)
        except Exception as e:
            raise RuntimeError(f"TCPStore.delete failed: {e}") from e

    def stop(self):
        """Drop this face's hold on the store; on the master the server
        stops once nothing else (a process group) holds it."""
        self._store = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass
