"""Structured tracing for the serving stack (port of
``repro/obs/trace.py``): span / instant / async-span / counter events in
the Chrome trace-event JSON format, loadable by Perfetto
(https://ui.perfetto.dev) and ``chrome://tracing``.

  ~zero cost when disabled   The hot loop is instrumented unconditionally;
      ``NullTracer`` (the engines' default) implements the whole surface
      as no-ops and returns one shared null context manager from ``span``.

  injectable clock           ``Tracer(clock=...)`` takes any zero-argument
      monotonic-seconds callable. Tests inject ``FakeClock`` (a fixed tick
      a call), so a seeded run emits byte-identical trace JSON. The default
      is ``time.perf_counter``.

  one track per component    Tracks are named strings ("router",
      "decode/w0", "freeze/w0", ...) mapped to Chrome ``tid``s in
      first-use order; ``to_dict`` emits the matching ``thread_name`` /
      ``thread_sort_index`` metadata, one labeled lane per component.

Every timestamp is the host's clock. On the card a span times the host's
enqueue of the work, not the card's execution of it: a span that ends in a
device sync (the decode step's ``sync``) absorbs the device time of
everything queued before it. The trace is not a device profile.

Event kinds (Chrome ``ph`` phases):

  span          "X" complete event with ts+dur: a timed phase. ``span()``
                when the args are known up front, or ``t0 = tracer.now();
                ...; tracer.complete(...)`` when they exist only at the end.
  instant       "i": a decision point (route, accept, reject).
  counter       "C": a per-step gauge (occupancy, modeled HBM bytes).
  async span    "b"/"n"/"e" with an id: a lifecycle that outlives one call
                frame. The page-freeze lifecycle (queued -> dispatched ->
                installed | dropped | rolled_back | offloaded), the page
                offload (-> restored) and in-flight prefills are async
                spans keyed by a caller-chosen id.
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Iterable


class FakeClock:
    """Deterministic test clock: advances ``tick`` seconds a call, so a
    seeded run's trace depends only on its event sequence."""

    def __init__(self, tick: float = 0.001, t0: float = 0.0) -> None:
        self.tick = tick
        self._t = t0

    def __call__(self) -> float:
        t = self._t
        self._t += self.tick
        return t


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """No-op tracer: the default everywhere, so an instrumentation point
    costs an attribute call when tracing is off."""

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


class _Span:
    """Context manager emitting one complete ("X") event on exit."""

    __slots__ = ("tr", "track", "name", "args", "t0")

    def __init__(self, tr: "Tracer", track: str, name: str,
                 args: dict[str, Any]) -> None:
        self.tr, self.track, self.name, self.args = tr, track, name, args

    def __enter__(self) -> "_Span":
        self.t0 = self.tr.clock()
        return self

    def __exit__(self, *exc: object) -> bool:
        self.tr._emit_complete(self.track, self.name, self.t0,
                               self.tr.clock(), self.args)
        return False


class Tracer:
    """Collects trace events in memory; ``write()`` emits Chrome trace
    JSON. Every timestamp comes from the injected ``clock``."""

    enabled = True
    PROCESS_NAME = "repro_torch.serving"

    def __init__(self, clock: Callable[[], float] | None = None, *,
                 pid: int = 0) -> None:
        self.clock = clock if clock is not None else time.perf_counter
        self.pid = pid
        self._t0 = self.clock()
        self.events: list[dict] = []
        self._tids: dict[str, int] = {}

    def now(self) -> float:
        """Seconds on the tracer clock (pair with ``complete``)."""
        return self.clock()

    def _us(self, t: float) -> float:
        return round((t - self._t0) * 1e6, 3)

    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = self._tids[track] = len(self._tids) + 1
        return tid

    def _emit_complete(self, track: str, name: str, t0: float, t1: float,
                       args: dict[str, Any]) -> None:
        ev = {"ph": "X", "name": name, "pid": self.pid,
              "tid": self._tid(track), "ts": self._us(t0),
              "dur": round((t1 - t0) * 1e6, 3)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def span(self, track: str, name: str, **args: Any) -> _Span:
        return _Span(self, track, name, args)

    def complete(self, track: str, name: str, t0: float,
                 **args: Any) -> None:
        """Close a region opened at ``t0 = tracer.now()``: for spans whose
        args (payload bytes, ...) exist only at the end."""
        self._emit_complete(track, name, t0, self.clock(), args)

    def instant(self, track: str, name: str, **args: Any) -> None:
        ev = {"ph": "i", "s": "t", "name": name, "pid": self.pid,
              "tid": self._tid(track), "ts": self._us(self.clock())}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, track: str, name: str, **values: Any) -> None:
        self.events.append({"ph": "C", "name": name, "pid": self.pid,
                            "tid": self._tid(track),
                            "ts": self._us(self.clock()), "args": values})

    def _async(self, ph: str, track: str, name: str, id: Any,
               args: dict[str, Any]) -> None:
        ev = {"ph": ph, "cat": track, "name": name, "id": str(id),
              "pid": self.pid, "tid": self._tid(track),
              "ts": self._us(self.clock())}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def async_begin(self, track: str, name: str, id: Any,
                    **args: Any) -> None:
        self._async("b", track, name, id, args)

    def async_instant(self, track: str, name: str, id: Any,
                      **args: Any) -> None:
        self._async("n", track, name, id, args)

    def async_end(self, track: str, name: str, id: Any,
                  **args: Any) -> None:
        self._async("e", track, name, id, args)

    def _metadata(self) -> list[dict]:
        meta = [{"ph": "M", "name": "process_name", "pid": self.pid,
                 "tid": 0, "args": {"name": self.PROCESS_NAME}}]
        for track, tid in sorted(self._tids.items(), key=lambda kv: kv[1]):
            meta.append({"ph": "M", "name": "thread_name", "pid": self.pid,
                         "tid": tid, "args": {"name": track}})
            meta.append({"ph": "M", "name": "thread_sort_index",
                         "pid": self.pid, "tid": tid,
                         "args": {"sort_index": tid}})
        return meta

    def to_dict(self) -> dict:
        return {"traceEvents": self._metadata() + self.events,
                "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        """Write the trace JSON: ``sort_keys`` and fixed separators keep
        the bytes deterministic for fake-clock runs."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, sort_keys=True,
                      separators=(",", ":"), allow_nan=False)


def count_events(events: Iterable[dict], *, track: str | None = None,
                 name: str | None = None, ph: str | None = None) -> int:
    """Count events matching the filters (``track`` matches an async
    event's ``cat``)."""
    return len(select_events(events, track=track, name=name, ph=ph))


def select_events(events: Iterable[dict], *, track: str | None = None,
                  name: str | None = None,
                  ph: str | None = None) -> list[dict]:
    out = []
    for ev in events:
        if name is not None and ev.get("name") != name:
            continue
        if ph is not None and ev.get("ph") != ph:
            continue
        if track is not None and ev.get("cat") != track:
            continue
        out.append(ev)
    return out


def tracks_of(tracer: Tracer) -> dict[str, int]:
    """Track name -> tid of a live tracer."""
    return dict(tracer._tids)
