"""PS server process wrapper over the native table server.

A copy of ``paddle_tpu/distributed/ps/server.py`` over the port's own host
library (``_native/host.py``). Paddle's `BrpcPsServer`
(``paddle/fluid/distributed/ps/service/brpc_ps_server.cc``) started by
`fleet.run_server()` (``distributed/ps/the_one_ps.py:1095``). Tables are created lazily by client
CREATE_TABLE requests, so the server itself needs no table configs up front.
"""
from __future__ import annotations

from .. import env as env_mod  # noqa: F401
from ..._native import host as _host


class PSServer:
    """One host-side table server. `run()` blocks until a client sends STOP."""

    def __init__(self, port: int = 0):
        self._lib = _host.load()
        self._h = self._lib.ps_server_create(port)
        if self._h < 0:
            raise RuntimeError(f"PSServer: cannot bind port {port}")
        self._lib.ps_server_start(self._h)
        self._stopped = False

    @property
    def port(self) -> int:
        return self._lib.ps_server_port(self._h)

    @property
    def endpoint(self) -> str:
        return f"127.0.0.1:{self.port}"

    def run(self):
        """Block until STOP (reference `fleet.run_server` blocking loop)."""
        self._lib.ps_server_wait(self._h)
        self.stop()

    def stop(self):
        if not self._stopped:
            self._stopped = True
            self._lib.ps_server_stop(self._h)

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass
