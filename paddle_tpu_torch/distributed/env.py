"""Process/cluster environment contract (a copy of
``paddle_tpu/distributed/env.py``).

Mirrors the trainer env-var contract set by paddle's
``paddle.distributed.launch`` and consumed by ``ParallelEnv``
(``python/paddle/fluid/dygraph/parallel.py:96``): ``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ENDPOINTS``,
``PADDLE_CURRENT_ENDPOINT``, ``PADDLE_DISTRI_BACKEND``.

A trainer here is one process driving one card (``FLAGS_selected_gpus``).
"""
from __future__ import annotations

import os
from typing import List

import torch


def find_free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


class ParallelEnv:
    """Cluster env view (paddle's ``fluid/dygraph/parallel.py:96``)."""

    def __init__(self):
        self._rank = _env_int("PADDLE_TRAINER_ID", 0)
        self._world_size = _env_int("PADDLE_TRAINERS_NUM", 1)
        self._device_id = _env_int("FLAGS_selected_gpus",
                                   _env_int("FLAGS_selected_tpus", 0))
        self._current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._trainer_endpoints: List[str] = eps.split(",") if eps else []
        self._nrings = _env_int("FLAGS_nccl_nrings", 1)

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def world_size(self) -> int:
        return self._world_size

    @property
    def device_id(self) -> int:
        return self._device_id

    @property
    def device_type(self) -> str:
        return "cuda" if torch.cuda.is_available() else "cpu"

    @property
    def current_endpoint(self) -> str:
        return self._current_endpoint

    @property
    def trainer_endpoints(self) -> List[str]:
        return self._trainer_endpoints

    @property
    def nrings(self) -> int:
        return self._nrings

    # legacy aliases (paddle keeps both spellings)
    local_rank = rank
    nranks = world_size
    dev_id = device_id


def get_cluster_env() -> ParallelEnv:
    return ParallelEnv()
