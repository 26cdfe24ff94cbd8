"""Serving metrics: per-request latency (TTFT / TPOT), aggregate
throughput, and KV-cache occupancy counters (port of
``repro/serving/metrics.py``; the speculative-decoding counters come with
that slice).

TTFT = first token time - arrival, split into its two components so
disaggregation wins attribute correctly:

  queue_wait      = prefill start - arrival   (admission + routing delay)
  prefill_compute = first token - prefill start

TPOT = mean inter-token time over the remaining tokens.

Aggregate cache/ITL series are streaming (``obs.stats`` gauges + log
histograms) — O(1) memory however long the run — instead of the raw
per-step lists this collector used to keep. Per-request state
(``RequestTrace``, including its decode ``gaps``) stays exact: it is
bounded by max_new_tokens and benches consume it directly. ``summary()``
keys are unchanged; ``snapshot()`` is the live view the JSONL/Prometheus
exporters poll mid-run.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.obs.stats import Registry


def percentile(xs, p: float) -> float | None:
    """None (key omitted upstream) instead of NaN on empty input — NaN is
    not valid strict JSON and used to poison BENCH_*.json artifacts."""
    if not len(xs):
        return None
    return float(np.percentile(np.asarray(xs, np.float64), p))


@dataclasses.dataclass
class RequestTrace:
    arrival_t: float
    prompt_len: int
    prefill_start_t: float | None = None
    first_token_t: float | None = None
    finish_t: float | None = None
    tokens: int = 0
    # per-token decode gaps (when the engine timestamps token events):
    # the distribution whose tail a prefill stall inflates
    gaps: list = dataclasses.field(default_factory=list)
    _last_t: float | None = None

    @property
    def ttft(self) -> float:
        return self.first_token_t - self.arrival_t

    @property
    def queue_wait(self) -> float:
        """Admission/routing delay before prefill compute started (falls
        back to the whole TTFT when no prefill_start was recorded)."""
        if self.prefill_start_t is None:
            return self.ttft
        return self.prefill_start_t - self.arrival_t

    @property
    def prefill_compute(self) -> float:
        if self.prefill_start_t is None:
            return 0.0
        return self.first_token_t - self.prefill_start_t

    @property
    def tpot(self) -> float:
        if self.tokens <= 1:
            return 0.0
        return (self.finish_t - self.first_token_t) / (self.tokens - 1)


class MetricsCollector:
    def __init__(self):
        self.traces: dict[int, RequestTrace] = {}
        self.stats = Registry()
        self.steps = 0
        # last cache sample where the pool held anything (fp-equiv > 0):
        # after the final eviction both sides are zero, so "final" keeps
        # meaning "steady state before teardown"
        self._cache_final: tuple[float, float] | None = None
        self._completed = 0
        self._completed_zero_token = 0
        self._gen_tokens_done = 0
        # admission outcomes, counted by reason: rejected_queue_full /
        # rejected_pool_full (hard doors), shed_slo / deferred (SLO-aware
        # policy). Keys surface in summary()/snapshot() only when nonzero
        # so the legacy key set is untouched on runs without overload.
        self._admission: dict[str, int] = {}

    # ----------------------------------------------------- request events

    def arrival(self, rid: int, t: float, prompt_len: int) -> None:
        self.traces[rid] = RequestTrace(arrival_t=t, prompt_len=prompt_len)
        self.stats.counter("requests_arrived").inc()

    def admission(self, reason: str) -> None:
        """Count one admission-control outcome by reason."""
        self._admission[reason] = self._admission.get(reason, 0) + 1

    def prefill_start(self, rid: int, t: float) -> None:
        tr = self.traces[rid]
        if tr.prefill_start_t is None:
            tr.prefill_start_t = t

    def first_token(self, rid: int, t: float) -> None:
        tr = self.traces[rid]
        tr.first_token_t = t
        tr.tokens = 1
        tr._last_t = t
        self.stats.histogram("ttft_s").observe(t - tr.arrival_t)

    def token(self, rid: int, t: float | None = None) -> None:
        tr = self.traces[rid]
        tr.tokens += 1
        self.stats.counter("tokens_generated").inc()
        if t is not None:
            if tr._last_t is not None:
                gap = t - tr._last_t
                tr.gaps.append(gap)
                self.stats.histogram("itl_s").observe(gap)
            tr._last_t = t

    def finish(self, rid: int, t: float) -> None:
        tr = self.traces[rid]
        tr.finish_t = t
        self._completed += 1
        self._gen_tokens_done += tr.tokens
        if tr.first_token_t is None:
            # finished without emitting anything (shed/rejected after
            # admission, or eos on first verify) — no latency to report
            self._completed_zero_token += 1

    # ----------------------------------------------------- cache sampling

    def sample_cache(self, occupancy: float, actual_bytes: float,
                     fp_bytes: float) -> None:
        self.steps += 1
        self.stats.gauge("cache_occupancy").set(occupancy)
        self.stats.gauge("cache_bytes").set(actual_bytes)
        self.stats.gauge("cache_bytes_fp").set(fp_bytes)
        if fp_bytes > 0:
            self.stats.gauge("cache_compression").set(fp_bytes / actual_bytes)
            self._cache_final = (actual_bytes, fp_bytes)

    # ----------------------------------------------------- aggregation

    def snapshot(self) -> dict:
        """Live mid-run view for the exporters: running totals + every
        streaming metric's snapshot. JSON-safe scalars only."""
        out = {"completed": self._completed,
               "completed_zero_token": self._completed_zero_token,
               "gen_tokens": self._gen_tokens_done,
               "steps": self.steps,
               "in_flight": len(self.traces) - self._completed}
        for k, v in self._admission.items():
            if v:
                out[k] = v
        out.update(self.stats.snapshot())
        return out

    def summary(self) -> dict:
        done = [t for t in self.traces.values() if t.finish_t is not None]
        # zero-token finishes have no first_token_t: excluding them from
        # the latency population (instead of raising on ttft's None
        # subtraction) keeps every key below well-defined
        zero = [t for t in done if t.first_token_t is None]
        done = [t for t in done if t.first_token_t is not None]
        if not done:
            out = {"completed": 0}
            if zero:
                out["completed_zero_token"] = len(zero)
            for k, v in self._admission.items():
                if v:
                    out[k] = v
            return out
        t0 = min(t.arrival_t for t in done)
        t1 = max(t.finish_t for t in done)
        gen = sum(t.tokens for t in done)
        ttfts = [t.ttft for t in done]
        tpots = [t.tpot for t in done if t.tokens > 1]
        out = {
            "completed": len(done),
            "gen_tokens": gen,
            "makespan_s": t1 - t0,
            "throughput_tok_s": gen / max(t1 - t0, 1e-9),
            "ttft_mean_s": float(np.mean(ttfts)),
            "ttft_p50_s": percentile(ttfts, 50),
            "ttft_p99_s": percentile(ttfts, 99),
        }
        if zero:
            out["completed_zero_token"] = len(zero)
        if tpots:
            out["tpot_p50_s"] = percentile(tpots, 50)
            out["tpot_p99_s"] = percentile(tpots, 99)
        # TTFT decomposition: queue_wait (admission + routing) vs
        # prefill_compute — the pair disaggregation trades against
        waits = [t.queue_wait for t in done]
        computes = [t.prefill_compute for t in done]
        out.update({
            "queue_wait_mean_s": float(np.mean(waits)),
            "queue_wait_p50_s": percentile(waits, 50),
            "queue_wait_p99_s": percentile(waits, 99),
            "prefill_compute_mean_s": float(np.mean(computes)),
            "prefill_compute_p50_s": percentile(computes, 50),
            "prefill_compute_p99_s": percentile(computes, 99),
        })
        # inter-token latency over every decode gap (engines that timestamp
        # token events): unlike the per-request tpot means above, a single
        # prefill stall lands in this distribution's tail undiluted
        gaps = [g for t in done for g in t.gaps]
        if gaps:
            out["itl_p50_s"] = percentile(gaps, 50)
            out["itl_p99_s"] = percentile(gaps, 99)
            out["itl_max_s"] = float(np.max(gaps))
        if "cache_occupancy" in self.stats:
            occ = self.stats.gauge("cache_occupancy")
            out["cache_occupancy_mean"] = occ.mean
            out["cache_occupancy_max"] = occ.vmax
        if self._cache_final is not None:
            act, fp = self._cache_final
            comp = self.stats.gauge("cache_compression")
            out["cache_bytes_final"] = float(act)
            out["cache_bytes_fp_final"] = float(fp)
            out["cache_compression_mean"] = comp.mean
            out["cache_compression_final"] = float(fp / act)
        # admission outcomes by reason, only when any occurred (keeps the
        # legacy summary key set byte-identical on unremarkable runs)
        for k, v in self._admission.items():
            if v:
                out[k] = v
        return out
