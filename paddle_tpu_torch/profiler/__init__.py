"""paddle_tpu_torch.profiler — the observability plane the port has so far
(counterpart of ``paddle_tpu/profiler``): the metrics registry, the
structured event log and the training-health plane. The rest (server,
throughput monitor, tracing) is ROADMAP A10's rest."""
