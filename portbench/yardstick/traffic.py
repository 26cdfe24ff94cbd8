"""The one general generator of the benchmark's traffic mixes.

A mix is a JSON file under ``portbench/traffic/`` whose ``kind`` says how
its requests reach the program:

- ``open_loop``: independent users. ``rate_rps * seconds`` requests (at
  least one) whose inter-arrival times follow a gamma law of coefficient
  of variation ``arrival.cv`` (1 is Poisson, 2 is bursty), rescaled so
  that the arrivals fill ``[0, seconds)``.
- ``batches``: offline batches of ``batch_size`` requests, all due at
  once, one after another.
- ``train``: packed rows of ``seq`` tokens, ``batch`` rows a step.

Every seed gets the same work. The lengths and the inter-arrival gaps are
drawn from the mix's own ``base_seed``, in that order; ``--seed`` draws
the token ids. So the runs of a cell replay one schedule with other
contents (and other weights): a permutation of the lengths and the gaps
by the seed moved the bursts and the long prompts, and with them the
tail and the drain, by tens of percent from seed to seed.
Lengths are lognormal around ``median`` with log-sd ``sigma``, rounded
and clipped to ``[min, max]``.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parents[1] / "traffic"


def load_mix(name: str) -> dict:
    """The mix ``portbench/traffic/<name>.json``."""
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` lognormal lengths, rounded and clipped to the spec's range."""
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def _tokens(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    return rng.integers(0, vocab, n, dtype=np.int64).astype(np.int32)


def open_loop(mix: dict, seed: int, seconds: float, vocab: int) -> list:
    """Requests ``{id, arrival, prompt, max_new}`` sorted by arrival."""
    rate = float(mix["rate_rps"])
    n = max(1, int(round(rate * seconds)))
    base = np.random.default_rng(mix["base_seed"])
    shape = 1.0 / mix["arrival"]["cv"] ** 2
    gaps = base.gamma(shape, 1.0 / (rate * shape), n + 1)
    plen = lengths(mix["prompt"], n, base)
    alen = lengths(mix["answer"], n, base)
    rng = np.random.default_rng(seed)
    # n + 1 gaps span the window, so the last arrival falls inside it
    t = np.cumsum(gaps)[:n] * (seconds / gaps.sum())
    return [{"id": i, "arrival": float(t[i]),
             "prompt": _tokens(rng, int(plen[i]), vocab),
             "max_new": int(alen[i])} for i in range(n)]


def batches(mix: dict, seed: int, vocab: int):
    """Successive batches (lists of requests due at 0), without end: each
    has the mix's ``batch_size`` lengths, with new tokens."""
    base = np.random.default_rng(mix["base_seed"])
    n = int(mix["batch_size"])
    plen = lengths(mix["prompt"], n, base)
    alen = lengths(mix["answer"], n, base)
    rng = np.random.default_rng(seed)
    k = 0
    while True:
        yield [{"id": k * n + i, "arrival": 0.0,
                "prompt": _tokens(rng, int(plen[i]), vocab),
                "max_new": int(alen[i])} for i in range(n)]
        k += 1


def train_rows(mix: dict, seed: int, step: int, vocab: int) -> np.ndarray:
    """Step ``step``'s (batch, seq + 1) token rows: the inputs are the
    first ``seq`` columns, the next-token labels the last ``seq``. Every
    row of every step differs."""
    rng = np.random.default_rng((seed, step))
    return rng.integers(0, vocab, (mix["batch"], mix["seq"] + 1),
                        dtype=np.int64)
