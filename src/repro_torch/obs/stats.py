"""Streaming metric primitives: counters, gauges and fixed-bucket log
histograms (port of ``repro/obs/stats.py``, copied because the port
imports nothing of ``repro``, jax-free modules included). Everything
here is fixed-size:

  Counter       monotonically increasing int.
  Gauge         streaming last/n/sum/min/max (mean derivable).
  LogHistogram  geometric buckets over [lo, hi) with underflow/overflow
                bins; ``percentile(p)`` answers from bucket counts with
                relative error bounded by the bucket ratio (~8%/bucket at
                the default 16 buckets/decade). A snapshot of the counts
                array ("counts-delta") gives *windowed* percentiles
                between two exporter ticks without storing samples.

``Registry`` is a flat name -> metric map; ``snapshot()`` renders every
metric to plain JSON-safe scalars for the JSONL/Prometheus exporters.
"""
from __future__ import annotations

import math
from typing import TypeVar, Union


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Streaming scalar: remembers last/min/max and running sum/count."""

    __slots__ = ("last", "n", "total", "vmin", "vmax")

    def __init__(self) -> None:
        self.last: float | None = None
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def set(self, v: float) -> None:
        v = float(v)
        self.last = v
        self.n += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    @property
    def mean(self) -> float | None:
        return self.total / self.n if self.n else None

    def snapshot(self) -> dict:
        return {"type": "gauge", "last": self.last, "n": self.n,
                "mean": self.mean,
                "min": self.vmin if self.n else None,
                "max": self.vmax if self.n else None}


class LogHistogram:
    """Fixed-bucket log histogram over [lo, hi).

    Bucket i covers [lo * r**i, lo * r**(i+1)) with r chosen so there are
    ``per_decade`` buckets per decade. Values below ``lo`` land in the
    underflow bin (reported as ``lo``); values >= ``hi`` in the overflow
    bin (reported as ``hi``). Exact min/max/sum are tracked alongside so
    p0/p100 and the mean stay exact; interior percentiles are bucket
    midpoints (geometric), error bounded by sqrt(r).

    Defaults suit latencies in seconds: 100ns .. 1000s.
    """

    __slots__ = ("lo", "hi", "per_decade", "_log_lo", "_inv_log_r",
                 "nbuckets", "counts", "underflow", "overflow",
                 "n", "total", "vmin", "vmax")

    def __init__(self, lo: float = 1e-7, hi: float = 1e3,
                 per_decade: int = 16) -> None:
        assert 0 < lo < hi
        self.lo, self.hi, self.per_decade = lo, hi, per_decade
        self._log_lo = math.log10(lo)
        self._inv_log_r = per_decade  # buckets per decade
        self.nbuckets = int(math.ceil(
            (math.log10(hi) - self._log_lo) * per_decade))
        self.counts = [0] * self.nbuckets
        self.underflow = 0
        self.overflow = 0
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _bucket(self, v: float) -> int:
        return int((math.log10(v) - self._log_lo) * self._inv_log_r)

    def observe(self, v: float) -> None:
        v = float(v)
        self.n += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v < self.lo:
            self.underflow += 1
        elif v >= self.hi:
            self.overflow += 1
        else:
            i = self._bucket(v)
            if i < 0:
                i = 0
            elif i >= self.nbuckets:
                i = self.nbuckets - 1
            self.counts[i] += 1

    # --------------------------------------------------------- percentile

    def _bucket_value(self, i: int) -> float:
        # geometric midpoint of bucket i
        return 10.0 ** (self._log_lo + (i + 0.5) / self.per_decade)

    def percentile(self, p: float, *, counts: list[int] | None = None,
                   underflow: int | None = None,
                   overflow: int | None = None,
                   n: int | None = None) -> float | None:
        """p in [0, 100]. Pass the delta fields to answer over a window."""
        counts = self.counts if counts is None else counts
        underflow = self.underflow if underflow is None else underflow
        overflow = self.overflow if overflow is None else overflow
        n = self.n if n is None else n
        if n <= 0:
            return None
        rank = p / 100.0 * n
        seen = underflow
        if rank <= seen and underflow:
            return max(self.vmin, 0.0) if self.vmin < self.lo else self.lo
        for i, c in enumerate(counts):
            if not c:
                continue
            seen += c
            if rank <= seen:
                v = self._bucket_value(i)
                # clamp to the exact observed range
                if self.vmin != math.inf:
                    v = min(max(v, self.vmin), self.vmax)
                return v
        # falls in overflow (or rounding): report the exact max
        return self.vmax if self.vmax != -math.inf else self.hi

    @property
    def mean(self) -> float | None:
        return self.total / self.n if self.n else None

    def state(self) -> dict:
        """Copy of the count state — store it, then pass ``delta(prev)``
        results back into ``percentile`` for windowed answers."""
        return {"counts": list(self.counts), "underflow": self.underflow,
                "overflow": self.overflow, "n": self.n}

    def delta(self, prev: dict) -> dict:
        return {"counts": [a - b for a, b in zip(self.counts,
                                                 prev["counts"])],
                "underflow": self.underflow - prev["underflow"],
                "overflow": self.overflow - prev["overflow"],
                "n": self.n - prev["n"]}

    def snapshot(self) -> dict:
        return {"type": "histogram", "n": self.n, "mean": self.mean,
                "min": self.vmin if self.n else None,
                "max": self.vmax if self.n else None,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}


Metric = Union[Counter, Gauge, LogHistogram]
_M = TypeVar("_M", Counter, Gauge, LogHistogram)


class Registry:
    """Flat name -> metric map with get-or-create accessors."""

    def __init__(self) -> None:
        self._metrics: dict[str, Metric] = {}

    def _get(self, name: str, cls: type[_M], *args: object,
             **kw: object) -> _M:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(*args, **kw)
        assert isinstance(m, cls), f"{name} registered as {type(m).__name__}"
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, **kw: object) -> LogHistogram:
        return self._get(name, LogHistogram, **kw)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str) -> Metric:
        return self._metrics[name]

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        """JSON-safe dump of every metric (sorted for determinism)."""
        return {name: self._metrics[name].snapshot()
                for name in self.names()}
