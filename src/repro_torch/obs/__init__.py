from .stats import Counter, Gauge, LogHistogram, Registry
from .trace import NULL_TRACER, NullTracer

__all__ = ["Counter", "Gauge", "LogHistogram", "Registry", "NULL_TRACER",
           "NullTracer"]
