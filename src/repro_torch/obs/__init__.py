"""Observability layer: per-request trace spans + process metrics registry.

No dependencies on the rest of ``repro_torch`` (or on torch) — runtime and
api import from here, never the other way around.
"""
from repro_torch.obs.metrics import (Counter, Gauge, MetricsRegistry,
                                     default_registry)
from repro_torch.obs.trace import Span, Trace, maybe_activate, span

__all__ = ["Counter", "Gauge", "MetricsRegistry", "default_registry", "Span",
           "Trace", "maybe_activate", "span"]
