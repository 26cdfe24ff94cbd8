"""Observability for the serving stack (port of ``repro/obs``).

``trace``   span/instant/async/counter events -> Chrome trace-event JSON
            (Perfetto-loadable), injectable clock, ``NullTracer`` no-op
            default.
``stats``   streaming counters/gauges/log-histograms with O(1)-memory
            windowed percentiles.
``export``  periodic JSONL snapshots, Prometheus text exposition, and
            host-side modeled roofline gauges for the decode loop.
"""
from .export import (MetricsExporter, modeled_decode_hbm_bytes,
                     modeled_prefill_hbm_bytes, prometheus_text)
from .stats import Counter, Gauge, LogHistogram, Registry
from .trace import (FakeClock, NULL_TRACER, NullTracer, Tracer,
                    count_events, select_events, tracks_of)

__all__ = [
    "Counter", "FakeClock", "Gauge", "LogHistogram", "MetricsExporter",
    "NULL_TRACER", "NullTracer", "Registry", "Tracer", "count_events",
    "modeled_decode_hbm_bytes", "modeled_prefill_hbm_bytes",
    "prometheus_text", "select_events", "tracks_of",
]
