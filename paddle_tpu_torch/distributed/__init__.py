"""Distributed training (counterpart of ``paddle_tpu/distributed``).

Ported so far: ``fleet.utils.recompute`` and single-host
``checkpoint``; the collectives, the parallel engines, the multi-host
checkpoint coordinator and the control plane are later slices."""
