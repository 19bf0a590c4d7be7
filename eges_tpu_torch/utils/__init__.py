"""Host-side utilities of the port: copies of the reference's metrics
registry, span tracer, sampling profiler, ingress ledger and device
stats (``eges_tpu/utils/``), each with its own process-wide state."""
