"""PS runtime: role wiring between fleet and the native server/client.

A copy of ``paddle_tpu/distributed/ps/runtime.py``. Paddle's
`TheOnePSRuntime` (``python/paddle/distributed/ps/the_one_ps.py:819``) and
the env
contract set by the launcher (`PADDLE_PSERVERS_IP_PORT_LIST`,
`PADDLE_TRAINERS_NUM`, `TRAINING_ROLE`, `PADDLE_TRAINER_ID` — see
`fleet/base/role_maker.py`). The same contract is kept so
launcher-driven (``--server_num N --trainer_num M``) scripts port over
unchanged.

Dense parameters can also live on the PS (`sync_dense` helpers): trainer 0
seeds the tables from its initial weights, every trainer pulls before a step
and pushes grads after — the reference's pull_dense/push_dense async loop
(`ps/service/communicator/communicator.h:232`), synchronous variant.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .client import PSClient, TableConfig
from .server import PSServer

_state = {
    "server": None,       # PSServer on PSERVER ranks
    "client": None,       # PSClient on TRAINER ranks
    "dense_map": None,    # param name -> table_id
}

# Dense tables get ids from 1000 up; sparse tables use user ids (0..999) —
# mirrors the reference's table-id partitioning in PsDescBuilder.
DENSE_TABLE_BASE = 1000


def role() -> str:
    return os.environ.get("TRAINING_ROLE", "TRAINER").upper()


def is_server() -> bool:
    return role() == "PSERVER"


def is_worker() -> bool:
    return not is_server()


def server_endpoints() -> List[str]:
    eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
    return [e for e in eps.split(",") if e]


def trainer_id() -> int:
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def num_trainers() -> int:
    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))


# ------------------------------ server side --------------------------------

def init_server(port: Optional[int] = None) -> PSServer:
    """Start this rank's table server (reference fleet.init_server)."""
    if _state["server"] is not None:
        return _state["server"]
    if port is None:
        port = int(os.environ.get("PADDLE_PORT", "0"))
    _state["server"] = PSServer(port)
    return _state["server"]


def run_server():
    """Serve until a worker calls shutdown() (reference fleet.run_server)."""
    if _state["server"] is None:
        init_server()
    _state["server"].run()


# ------------------------------ worker side --------------------------------

def init_worker(endpoints: Optional[List[str]] = None,
                mode: str = "sync", geo_lr: Optional[float] = None,
                geo_push_steps: Optional[int] = None) -> PSClient:
    """Connect to all table servers (reference fleet.init_worker).

    mode="async" wraps the client in a background Communicator (reference
    AsyncCommunicator): pushes batch+merge off the critical path; pulls see
    slightly stale server state.

    mode="geo" wraps it in a GeoCommunicator (reference GeoCommunicator +
    memory_sparse_geo_table): local-SGD on a cached sparse table with
    periodic weight-delta push/merge — create sparse tables with
    optimizer="sum" for this mode."""
    if _state["client"] is not None:
        return _state["client"]
    eps = endpoints or server_endpoints()
    if not eps:
        raise RuntimeError(
            "init_worker: no PS endpoints (set PADDLE_PSERVERS_IP_PORT_LIST)")
    client = PSClient(eps)
    # an explicit non-default mode argument wins; the env is a fallback for
    # launcher-driven configs where user code passes no mode
    if mode == "sync":
        mode = os.environ.get("PADDLE_PS_MODE", mode)
    if mode == "geo":
        from .communicator import GeoCommunicator
        lr = geo_lr if geo_lr is not None else float(
            os.environ.get("PADDLE_PS_GEO_LR", 0.01))
        steps = geo_push_steps if geo_push_steps is not None else int(
            os.environ.get("PADDLE_PS_GEO_PUSH_STEPS", 8))
        geo = GeoCommunicator(client, lr=lr, geo_push_steps=steps)
        _state["client"] = geo
        return geo
    if mode == "async":
        from .communicator import Communicator
        comm = Communicator(client)
        comm.start()
        client = comm
    _state["client"] = client
    return _state["client"]


def get_client() -> PSClient:
    if _state["client"] is None:
        return init_worker()
    return _state["client"]


def barrier_worker(name: str = "worker"):
    """Barrier across trainers, coordinated by server 0."""
    get_client().barrier(name, num_trainers())


def stop_worker():
    """Trainer-side teardown: final barrier, then trainer 0 stops servers."""
    c = _state["client"]
    if c is None:
        return
    if hasattr(c, "flush"):  # async communicator: land queued grads first
        c.stop()
    c.barrier("stop_worker", num_trainers())
    if trainer_id() == 0:
        c.stop_servers()
    _state["client"] = None


def shutdown():
    """Force-stop servers from any process (tests / emergency path)."""
    if _state["client"] is not None:
        _state["client"].stop_servers()
        _state["client"] = None
    if _state["server"] is not None:
        _state["server"].stop()
        _state["server"] = None


def save_persistables(dirname: str):
    get_client().save(dirname)


def load_persistables(dirname: str):
    get_client().load(dirname)


# --------------------- dense-on-PS (sync mode) helpers ----------------------

def register_dense_params(model, optimizer: str = "sgd",
                          learning_rate: float = 0.01) -> Dict[str, int]:
    """Create one dense table per parameter; trainer 0 seeds initial values.

    Returns the param-name -> table-id map (also cached for the sync helpers).
    """
    client = get_client()
    mapping: Dict[str, int] = {}
    for i, (name, p) in enumerate(model.named_parameters()):
        tid = DENSE_TABLE_BASE + i
        client.create_table(TableConfig(
            table_id=tid, kind="dense", dense_size=int(np.prod(p.shape)),
            optimizer=optimizer, learning_rate=learning_rate))
        mapping[name] = tid
    if trainer_id() == 0:
        for name, p in model.named_parameters():
            client.set_dense(mapping[name], p.detach().cpu().numpy())
    barrier_worker("dense_init")
    _state["dense_map"] = mapping
    return mapping


def pull_dense_params(model):
    """Refresh local params from the PS (start-of-step in sync mode)."""
    client = get_client()
    mapping = _state["dense_map"]
    with torch.no_grad():
        for name, p in model.named_parameters():
            vals = client.pull_dense(mapping[name]).reshape(tuple(p.shape))
            p.copy_(torch.from_numpy(vals))


def push_dense_grads(model, scale: float = 1.0):
    """Push local grads; the server-side optimizer applies the update."""
    client = get_client()
    mapping = _state["dense_map"]
    for name, p in model.named_parameters():
        if p.grad is not None:
            client.push_dense(mapping[name],
                              p.grad.detach().cpu().numpy() * scale)
