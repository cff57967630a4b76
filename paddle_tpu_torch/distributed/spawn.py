"""paddle.distributed.spawn — multiprocessing launch from Python
(counterpart of ``paddle_tpu/distributed/spawn.py``).

``spawn(func, args, nprocs)`` starts ``nprocs`` processes (the ``spawn``
start method: a child re-imports ``func``'s module, so keep ``func`` at
a module's top level), gives each the trainer env contract (rank, world,
endpoints, ``MASTER_ADDR``/``MASTER_PORT`` of the rendezvous, one card a
process), and joins them. ``nprocs`` 1 runs ``func`` inline with the
contract set, as the reference does.
"""
from __future__ import annotations

import multiprocessing as mp
import os
from typing import Tuple

_ENV_KEYS = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
             "PADDLE_TRAINER_ENDPOINTS", "PADDLE_CURRENT_ENDPOINT",
             "PADDLE_LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
             "FLAGS_selected_gpus")


def _env_for(i: int, nprocs: int, endpoints: str) -> dict:
    host, port = endpoints.split(",")[0].rsplit(":", 1)
    return {"PADDLE_TRAINER_ID": str(i), "PADDLE_TRAINERS_NUM": str(nprocs),
            "PADDLE_TRAINER_ENDPOINTS": endpoints,
            "PADDLE_CURRENT_ENDPOINT": endpoints.split(",")[i],
            "PADDLE_LOCAL_RANK": str(i), "MASTER_ADDR": host,
            "MASTER_PORT": port, "FLAGS_selected_gpus": str(i)}


def _worker(func, i, args, env, queue):
    os.environ.update(env)
    try:
        func(*args)
        queue.put((i, None))
    except Exception as e:  # surface the traceback to the parent
        import traceback
        queue.put((i, f"{e}\n{traceback.format_exc()}"))
        raise


def spawn(func, args: Tuple = (), nprocs: int = -1, join: bool = True,
          daemon: bool = False, **options):
    """Run ``func(*args)`` in ``nprocs`` processes with the trainer env
    set; returns a context whose ``join(timeout)`` returns False while
    workers still run and raises when one failed. Inside a
    launcher-started worker, one process runs inline."""
    from .env import find_free_port
    if nprocs < 1:
        nprocs = 1
    if nprocs == 1:
        saved = {k: os.environ.get(k) for k in _ENV_KEYS}
        if saved["PADDLE_TRAINER_ID"] is None:  # not under a launcher
            os.environ.update(_env_for(
                0, 1, f"127.0.0.1:{find_free_port()}"))
        try:
            func(*args)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        return None
    ctx = mp.get_context(options.get("start_method", "spawn"))
    queue = ctx.SimpleQueue()
    port0 = find_free_port()
    endpoints = ",".join(f"127.0.0.1:{port0 + i}" for i in range(nprocs))
    procs = []
    for i in range(nprocs):
        p = ctx.Process(target=_worker, args=(
            func, i, args, _env_for(i, nprocs, endpoints), queue),
            daemon=daemon)
        p.start()
        procs.append(p)

    class Context:
        def __init__(self):
            self.processes = procs

        def join(self, timeout=None):
            errs = []
            for p in procs:
                p.join(timeout)
            if any(p.is_alive() for p in procs):
                return False  # timed out with workers still running
            while not queue.empty():
                i, err = queue.get()
                if err is not None:
                    errs.append(f"rank {i}: {err}")
            for p in procs:
                if p.exitcode not in (0, None):
                    errs.append(f"process exit {p.exitcode}")
            if errs:
                raise RuntimeError("spawn workers failed:\n" +
                                   "\n".join(errs))
            return True

    context = Context()
    if join:
        context.join()
    return context
