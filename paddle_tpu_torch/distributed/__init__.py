"""Distributed training (counterpart of ``paddle_tpu/distributed``).

Only ``fleet.utils.recompute`` is ported so far; the collectives, the
parallel engines and the control plane are later slices."""
