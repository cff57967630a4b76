"""paddle_tpu_torch.profiler — the observability plane the port has so far
(counterpart of ``paddle_tpu/profiler``): the metrics registry, the
structured event log, the training-health plane, and the serving
engine's request tracer (``reqtrace``) and SLO tracker (``slo``). The
rest (server, throughput monitor, tracing) is ROADMAP A10's rest."""
