"""The ``incubate`` subset of the port: the fused transformer layers."""
