"""Distributed training (counterpart of ``paddle_tpu/distributed``).

Ported so far: ``fleet.utils.recompute``, single-host ``checkpoint``,
``env`` and the parameter server (``ps``: the table server and client,
``SparseEmbedding``, the hot-row cache and ``HeterPSTrainStep``); the
collectives, the parallel engines, the multi-host checkpoint coordinator
and the control plane are later slices."""
