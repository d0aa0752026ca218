"""Observability layer: per-request trace spans, process metrics registry and
their export sinks.

No dependencies on the rest of ``repro_torch`` (or on torch) — runtime, api
and serve import from here, never the other way around.
"""
from repro_torch.obs.export import (JsonLinesReporter, chrome_trace,
                                    write_chrome_trace)
from repro_torch.obs.metrics import (LATENCY_BUCKETS_MS, OCCUPANCY_BUCKETS,
                                     Counter, Gauge, Histogram,
                                     LabeledRegistry, MetricsRegistry,
                                     default_registry, render_key)
from repro_torch.obs.trace import (Span, Trace, current_trace, maybe_activate,
                                   set_span_hook, span)

__all__ = [
    "Counter", "Gauge", "Histogram", "LabeledRegistry", "MetricsRegistry",
    "LATENCY_BUCKETS_MS", "OCCUPANCY_BUCKETS", "default_registry",
    "render_key", "Span", "Trace", "current_trace", "maybe_activate",
    "set_span_hook", "span",
    "JsonLinesReporter", "chrome_trace", "write_chrome_trace",
]
