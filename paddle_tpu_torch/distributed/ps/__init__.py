"""Parameter-server training, the sparse/CTR path (counterpart of
``paddle_tpu/distributed/ps/``).

Paddle's PS stack (``paddle/fluid/distributed/ps/`` — BrpcPsServer/
BrpcPsClient, memory_sparse_table; the python side is
``paddle.distributed.fleet``'s PS mode and ``the_one_ps.py:819``). The
large embedding tables live on host-side C++ servers (the port's own copy
of the table server, ``_native/host_csrc/ps.cc``); the card runs the dense
math. A trainer pulls rows for the feasigns in its batch, computes on the
card, and pushes sparse gradients back; the optimizer for PS-resident
state runs inside the table (server-side SGD/Adagrad/Adam).
"""
from .client import PSClient, PSRequestError, TableConfig
from .server import PSServer
from .embedding import SparseEmbedding
from .cache import HotRowCache
from .heter import HeterPSTrainStep
from .communicator import Communicator, GeoCommunicator
from . import runtime
from .runtime import (init_server, run_server, init_worker, stop_worker,
                      barrier_worker, get_client, is_server, is_worker,
                      save_persistables, load_persistables, shutdown)

__all__ = [
    "PSClient", "PSRequestError", "PSServer", "TableConfig",
    "SparseEmbedding", "HotRowCache", "HeterPSTrainStep", "Communicator",
    "GeoCommunicator", "init_server", "run_server", "init_worker",
    "stop_worker", "barrier_worker", "get_client", "is_server", "is_worker",
    "save_persistables", "load_persistables", "shutdown", "runtime",
]
