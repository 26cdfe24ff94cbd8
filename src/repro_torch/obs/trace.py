"""Null tracer (port of ``repro/obs/trace.py:NullTracer``).

The serving hot loop is instrumented unconditionally; this no-op tracer
implements the reference's tracer surface so every instrumentation point
costs an attribute call. The recording ``Tracer`` and its exporters come in
a later slice.
"""
from __future__ import annotations

from typing import Any


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """No-op tracer: the default everywhere."""

    enabled = False
    events: tuple = ()

    def now(self) -> float:
        return 0.0

    def span(self, track: str, name: str, **args: Any) -> _NullSpan:
        return _NULL_SPAN

    def complete(self, track: str, name: str, t0: float,
                 **args: Any) -> None:
        pass

    def instant(self, track: str, name: str, **args: Any) -> None:
        pass

    def counter(self, track: str, name: str, **values: Any) -> None:
        pass

    def async_begin(self, track: str, name: str, id: Any,
                    **args: Any) -> None:
        pass

    def async_instant(self, track: str, name: str, id: Any,
                      **args: Any) -> None:
        pass

    def async_end(self, track: str, name: str, id: Any,
                  **args: Any) -> None:
        pass

    def to_dict(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        pass


NULL_TRACER = NullTracer()
