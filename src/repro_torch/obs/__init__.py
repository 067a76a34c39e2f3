"""Observability layer: span tracing, metrics registry, bounded events.

``repro_torch.obs`` is dependency-free (stdlib only) and imported by the
serving stack, the traffic harness, and the benches:

* :mod:`repro_torch.obs.trace` — span tracer emitting Chrome ``trace_event``
  JSON (Perfetto-loadable) + a JSONL span log; wall-clock spans from the
  engines/pipeline, virtual-clock spans from the traffic harness. The
  shared :data:`NULL_TRACER` keeps the disabled hot path at one
  attribute check.
* :mod:`repro_torch.obs.metrics` — process-wide counters/gauges/fixed-bucket
  histograms absorbing the serving layers' ``stats()`` dicts into one
  snapshot (the schema-v4 bench envelope's ``metrics`` block).
* :mod:`repro_torch.obs.events` — the bounded :class:`EventLog` ring behind
  the Scheduler's unified event stream (absolute indexing + ``drain``).
"""
from repro_torch.obs.events import EventLog
from repro_torch.obs.metrics import (DEFAULT_MS_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry, log_buckets,
                                     registry, reset_registry)
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Tracer,
                                   validate_chrome_trace)

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "validate_chrome_trace",
           "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "log_buckets", "registry", "reset_registry",
           "DEFAULT_MS_BUCKETS", "EventLog"]
