"""Unified telemetry layer: clocks, spans, metrics, facade.

Import surface::

    from repro_torch.obs import (Clock, ManualClock, MONOTONIC, as_clock,
                           Span, Tracer, NULL_TRACER,
                           MetricsRegistry, NULL_REGISTRY,
                           Telemetry, Recording, EventChannel,
                           NULL_TELEMETRY, make_telemetry)

``repro_torch.obs`` deliberately imports nothing from the rest of the repo,
so core and backend modules can depend on it without cycles; it imports
torch only where a live tracer opens a span or a telemetry reads its
device counters.
"""
from repro_torch.obs.clock import (Clock, ManualClock, MonotonicClock, MONOTONIC,
                             as_clock)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               NULL_REGISTRY, DEFAULT_BUCKETS)
from repro_torch.obs.trace import Span, Tracer, NullTracer, NULL_TRACER
from repro_torch.obs.telemetry import (Telemetry, Recording, EventChannel,
                                 NULL_TELEMETRY, make_telemetry)

__all__ = [
    "Clock", "ManualClock", "MonotonicClock", "MONOTONIC", "as_clock",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL_REGISTRY",
    "DEFAULT_BUCKETS",
    "Span", "Tracer", "NullTracer", "NULL_TRACER",
    "Telemetry", "Recording", "EventChannel", "NULL_TELEMETRY",
    "make_telemetry",
]
