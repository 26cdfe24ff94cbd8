"""The end-to-end metrics, taken by the benchmark on the host's clock from
what a driver returns (``records``: one dict per request of the window
with its scheduled ``arrival``, ``first`` token time, decode ``gaps`` and
``served`` tokens; ``window``: its start and end; ``steps``/``tokens`` of
a training window).

A request that was rejected or never produced a token adds no token and
no gap; the run counts it in ``failed``, and the per-layer
``ttft_p90_ms`` counts it as missing.
"""
from __future__ import annotations

from .stats import percentile


def itl_p95_ms(out: dict) -> float:
    gaps = [g for r in out["records"] for g in r["gaps"]]
    return 1e3 * percentile(gaps, 95)


def output_tokens_per_s(out: dict) -> float:
    w0, w1 = out["window"]
    return sum(len(r["served"]) for r in out["records"]) / (w1 - w0)


def train_tokens_per_s(out: dict) -> float:
    w0, w1 = out["window"]
    return out["tokens"] / (w1 - w0)


def setup_s(out: dict) -> float:
    return out["setup_s"]


METRICS = {f.__name__: f for f in (itl_p95_ms, output_tokens_per_s,
                                   train_tokens_per_s, setup_s)}
