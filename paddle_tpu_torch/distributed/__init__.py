"""Distributed training (counterpart of ``paddle_tpu/distributed``).

The reference is one controller over a ``jax.sharding.Mesh``; the port
is one process per rank over ``torch.distributed``. They meet in one
rule: **rank r of the port is device r of the reference's group** — what
the port's rank r holds equals shard r of the reference's tensor, and a
replicated tensor is the same value on every rank. ``get_rank()`` /
``get_world_size()`` are the process's (``PADDLE_TRAINER_ID`` /
``PADDLE_TRAINERS_NUM``); a ``Group``'s ``rank``/``nranks`` its own view.
``shard_batch(t)`` takes the global batch and returns this rank's rows,
``replicate(t)`` broadcasts from rank 0, so one script drives either
package. The backend is ``nccl`` with one card a rank, ``gloo`` under
``PADDLE_DISTRI_BACKEND=gloo`` or on the CPU (``get_backend()``).

Ported: process groups and the collectives (``collective``), the
rendezvous store (``store.TCPStore``), ``init_parallel_env``,
``DataParallel``, ``spawn``, ``launch``, the topology, the checkpoint
(single host and the coordinated multi-host commit), ZeRO sharding
(``sharding.group_sharded_parallel`` at its three levels, eager and in
``jit.TrainStep``), the chunked sharded checkpoint with its re-sharding
restore (``sharded_checkpoint``), ``fleet.utils`` and
``fleet.DistributedStrategy``, the parameter server (``ps``), and the
pipeline (``meta_parallel``: ``PipelineLayer``, ``PipelineParallel`` and
``PipelineParallelTrainStep``, a 1F1B over the ``pp`` group). Tensor and
sequence parallelism (``fleet``'s collective facade, the tensor-parallel
layers, ``auto_parallel``) are later slices of ROADMAP A11; ``split``,
``fleet.init`` and ``fleet.distributed_model`` raise naming it.
"""
from __future__ import annotations

from .env import ParallelEnv  # noqa: F401
from .collective import (  # noqa: F401
    CollectiveTimeoutError, Group, ReduceOp, all_gather, all_gather_object,
    all_reduce, alltoall, alltoall_single, barrier, broadcast,
    destroy_process_group, get_group, get_world_size_in_group, irecv,
    is_initialized, isend, new_group, ppermute, recv, reduce,
    reduce_scatter, scatter, send, split, stream_synchronize, wait,
)
from .parallel import (  # noqa: F401
    DataParallel, get_backend, get_rank, get_world_size, init_parallel_env,
    is_available, parallel_device_count, replicate, shard_batch,
)
from .topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup, build_mesh,
    get_hybrid_communicate_group, set_hybrid_communicate_group,
)
from .store import TCPStore  # noqa: F401
from .spawn import spawn  # noqa: F401
from . import checkpoint  # noqa: F401
from . import launch  # noqa: F401
from . import sharded_checkpoint  # noqa: F401
from . import sharding  # noqa: F401
from . import fleet  # noqa: F401
from . import meta_parallel  # noqa: F401
