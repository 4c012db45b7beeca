"""Host-side serving observability: the metrics registry and the
per-request lifecycle tracer, with the reference package's metric and
event names."""

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, NullMetricsRegistry,
                                     NULL_METRICS)
from repro_torch.obs.tracer import (RequestRecord, Tracer, NullTracer,
                                    NULL_TRACER)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "NullMetricsRegistry", "NULL_METRICS",
    "RequestRecord", "Tracer", "NullTracer", "NULL_TRACER",
]
