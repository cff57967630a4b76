"""fleet (counterpart of ``paddle_tpu/distributed/fleet``):
``DistributedStrategy`` and ``utils``.

Fleet's collective facade, ``init`` and ``distributed_model``, waits for
the tensor-parallel layers (ROADMAP A11 item 2): both raise naming it.
The pipeline is built from a strategy and a ``HybridCommunicateGroup``
directly (``meta_parallel.PipelineParallel``).
"""
from __future__ import annotations

from . import utils  # noqa: F401  (fleet.utils.recompute)
from .distributed_strategy import DistributedStrategy  # noqa: F401

_FACADE = "ROADMAP A11 item 2 (fleet's collective facade with the " \
          "tensor-parallel layers)"

__all__ = ["DistributedStrategy", "init", "distributed_model", "utils"]


def init(role_maker=None, is_collective=True, strategy=None, **kw):
    """fleet.init: not ported yet."""
    raise NotImplementedError(
        f"fleet.init waits for {_FACADE}; build the topology with "
        f"distributed.HybridCommunicateGroup(dims=...) and "
        f"set_hybrid_communicate_group")


def distributed_model(model):
    """fleet.distributed_model: not ported yet."""
    raise NotImplementedError(
        f"fleet.distributed_model waits for {_FACADE}; wrap a pipelined "
        f"model in meta_parallel.PipelineParallel, a data-parallel one in "
        f"distributed.DataParallel")
