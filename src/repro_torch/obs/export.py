"""Metrics export (port of ``repro/obs/export.py``): periodic JSONL
snapshots, Prometheus-style text exposition, and host-side modeled
roofline gauges for the decode loop.

``MetricsExporter`` hangs off an engine's run loop: ``maybe_emit()`` is
called every iteration and writes only when ``interval_s`` elapsed on the
injected clock. Each line is strict JSON (``allow_nan=False``), and the
windowed percentiles of every log histogram come from a counts-delta
against the previous emit: no samples stored.

``modeled_decode_hbm_bytes`` prices the next decode step's KV traffic
from host state only (the worker's numpy block table and lengths, its
installed-frozen page set, its per-page byte model ``page_bytes``), so the
run loop publishes bytes/token and a roofline ``t_memory`` every step
without reading anything back from the card. The memory rate is the
H100's (``device.HBM_BYTES_PER_S``).
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable

from repro_torch.device import HBM_BYTES_PER_S

from .stats import LogHistogram, Registry


class MetricsExporter:
    """Periodic JSONL metrics snapshots with windowed histogram
    percentiles. ``path=None`` keeps lines in ``self.lines`` only."""

    def __init__(self, path: str | None = None, *, interval_s: float = 1.0,
                 clock: Callable[[], float] | None = None,
                 registry: Registry | None = None) -> None:
        self.path = path
        self.interval_s = interval_s
        self.clock = clock if clock is not None else time.perf_counter
        self.registry = registry
        self.lines: list[dict] = []
        self._file = open(path, "w") if path else None
        self._last_emit: float | None = None
        self._hist_states: dict[str, dict] = {}
        self.seq = 0

    def _windowed(self, registry: Registry) -> dict:
        """p50/p99 over the interval since the previous emit, from
        histogram counts-deltas (O(buckets), no samples retained)."""
        out: dict[str, dict] = {}
        for name in registry.names():
            m = registry[name]
            if not isinstance(m, LogHistogram):
                continue
            prev = self._hist_states.get(name)
            delta = m.state() if prev is None else m.delta(prev)
            self._hist_states[name] = m.state()
            if delta["n"] > 0:
                out[name] = {"n": delta["n"],
                             "p50": m.percentile(50, **delta),
                             "p99": m.percentile(99, **delta)}
        return out

    def maybe_emit(self, metrics: Any = None, *, force: bool = False,
                   extra: dict | None = None) -> dict | None:
        """Emit one snapshot line if ``interval_s`` elapsed (or ``force``).

        ``metrics`` is anything with ``snapshot()`` and ``stats`` (a
        ``MetricsCollector``) or a bare ``Registry``; by default the
        registry bound at construction."""
        now = self.clock()
        if not force and self._last_emit is not None \
                and now - self._last_emit < self.interval_s:
            return None
        self._last_emit = now
        src = metrics if metrics is not None else self.registry
        registry = getattr(src, "stats", src)
        line = {"seq": self.seq, "t": round(now, 6)}
        self.seq += 1
        line.update(src.snapshot() if hasattr(src, "snapshot") else {})
        win = self._windowed(registry) if registry is not None else {}
        if win:
            line["window"] = win
        if extra:
            line.update(extra)
        self.lines.append(line)
        if self._file is not None:
            json.dump(line, self._file, sort_keys=True, allow_nan=False)
            self._file.write("\n")
            self._file.flush()
        return line

    def close(self, metrics: Any = None) -> None:
        """A final forced snapshot, then release the file."""
        self.maybe_emit(metrics, force=True)
        if self._file is not None:
            self._file.close()
            self._file = None


def _prom_name(name: str) -> str:
    return "".join(ch if ch.isalnum() or ch == "_" else "_" for ch in name)


def prometheus_text(snapshot: dict, *, prefix: str = "repro") -> str:
    """Render a ``Registry.snapshot()`` / ``MetricsCollector.snapshot()``
    dict as Prometheus text exposition (counters -> _total, gauges ->
    last + _mean/_max, histograms -> quantile-labeled summaries). The
    prefix is the reference's, so both packages' dashboards read one
    metric family."""
    lines: list[str] = []
    for name in sorted(snapshot):
        v = snapshot[name]
        base = f"{prefix}_{_prom_name(name)}"
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            lines.append(f"# TYPE {base} gauge")
            lines.append(f"{base} {v}")
            continue
        if not isinstance(v, dict):
            continue
        kind = v.get("type")
        if kind == "counter":
            lines.append(f"# TYPE {base}_total counter")
            lines.append(f"{base}_total {v['value']}")
        elif kind == "gauge":
            lines.append(f"# TYPE {base} gauge")
            if v.get("last") is not None:
                lines.append(f"{base} {v['last']}")
            for stat in ("mean", "max"):
                if v.get(stat) is not None:
                    lines.append(f"{base}_{stat} {v[stat]}")
        elif kind == "histogram":
            lines.append(f"# TYPE {base} summary")
            for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
                if v.get(key) is not None:
                    lines.append(f'{base}{{quantile="{q}"}} {v[key]}')
            lines.append(f"{base}_count {v['n']}")
            if v.get("mean") is not None:
                lines.append(f"{base}_sum {v['mean'] * v['n']}")
    return "\n".join(lines) + "\n"


def modeled_decode_hbm_bytes(worker: Any) -> dict | None:
    """Price the KV traffic of a ``DecodeWorker``'s next decode step from
    host state only (no device read).

    gather reads every gathered page at fp width:
        bytes = pages_used * page_fp
    fused reads each live sequence's own pages at their installed width
    (frozen pages as codes + codebooks):
        bytes = sum over live sequences and their pages of
                page_frozen if installed-frozen else page_fp

    Returns the step's totals, bytes/token (a token: one step of one live
    sequence) and the roofline ``t_memory`` of the worker's read path;
    None when no sequence is live."""
    active = worker.sched.active_slots()
    if not active:
        return None
    bs = worker.block_size
    pb = worker._pb
    need = int(worker.lens.max()) + 1
    mb_used = max(1, -(-need // bs))
    gather = mb_used * pb["fp"]
    fused = 0.0
    for i in active:
        npages = -(-(int(worker.lens[i]) + 1) // bs)
        for j in range(npages):
            blk = int(worker.table[i, j])
            fused += pb["frozen"] if blk in worker._frozen_pages else pb["fp"]
    step_bytes = gather if worker.attn_impl == "gather" else fused
    return {"hbm_bytes_step": float(step_bytes),
            "hbm_bytes_per_token": float(step_bytes) / len(active),
            "hbm_bytes_step_gather": float(gather),
            "hbm_bytes_step_fused": float(fused),
            "t_memory_s": float(step_bytes) / HBM_BYTES_PER_S}


def modeled_prefill_hbm_bytes(pb: dict, blocks, frozen_pages, *,
                              block_size: int, off: int, chunk: int,
                              fused: bool) -> dict:
    """Price one prefill chunk's KV page traffic from host state only.

    The chunk at token offset ``off`` attends pages 0..ceil((off+chunk)/bs).
    fused reads each of those pages at its installed width (frozen pages
    as codes + codebooks); gather expands every page of the table at fp
    width."""
    npages = max(1, -(-(off + chunk) // block_size))
    if fused:
        hbm = sum(pb["frozen"] if int(b) in frozen_pages else pb["fp"]
                  for b in blocks[:npages])
    else:
        hbm = len(blocks) * pb["fp"]
    return {"hbm_bytes_chunk": float(hbm),
            "hbm_bytes_per_token": float(hbm) / max(chunk, 1),
            "t_memory_s": float(hbm) / HBM_BYTES_PER_S}
