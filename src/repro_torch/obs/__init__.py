"""Host-side serving observability: the metrics registry, the
per-request lifecycle tracer, derived latency/occupancy/roofline views,
time-windowed series, SLO/goodput accounting, and JSONL + Chrome-trace
exports, with the reference package's metric and event names.

Pure Python over scalars the scheduler reads after its dispatches; the
port keeps its own copy of each reference module (the same values and
exported bytes on the same events).
"""

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, NullMetricsRegistry,
                                     NULL_METRICS)
from repro_torch.obs.tracer import (RequestRecord, Tracer, NullTracer,
                                    NULL_TRACER)
from repro_torch.obs.views import (occupancy_summary, percentiles,
                                   phase_summary, request_latency_summary,
                                   roofline_efficiency, summary_table)
from repro_torch.obs.windows import window_series, window_summary
from repro_torch.obs.slo import (SLOSpec, attainment, goodput,
                                 max_sustainable_rate, request_met,
                                 slo_report)
from repro_torch.obs.export import write_chrome_trace, write_jsonl

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "NullMetricsRegistry", "NULL_METRICS",
    "RequestRecord", "Tracer", "NullTracer", "NULL_TRACER",
    "percentiles", "request_latency_summary", "phase_summary",
    "occupancy_summary", "roofline_efficiency", "summary_table",
    "window_series", "window_summary",
    "SLOSpec", "request_met", "attainment", "goodput", "slo_report",
    "max_sustainable_rate",
    "write_jsonl", "write_chrome_trace",
]
