"""Operators of the port; the hand-written kernels live in ``ops.kernels``."""
