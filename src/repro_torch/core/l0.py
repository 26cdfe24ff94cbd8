"""l0-constrained sparse-LSQ quantization (port of ``repro/core/l0.py``;
paper eq. 16, L0Learn-style).

Penalized-l0 cyclic CD with ``cd.py``'s O(m) sweep, under a hard
threshold: keeping coordinate k at its LS value t = g / z_k improves the
smooth part by g^2 / (2 z_k), and it is kept iff that beats the penalty
gamma. The constrained form ||alpha||_0 <= l is reached by bisection on
gamma. The map gamma -> support size is a step function, so some counts
are unreachable: the paper's "non-universal" observation (§3.3, §4).

The sweep runs as ``cd.py``'s does, a loop over Python floats (float64)
on a host copy of the problem; the reference scans in f32, so an alpha
next to a threshold tie may flip between the two.
"""
from __future__ import annotations

import numpy as np
import torch

from .cd import _host
from .problem import LSQProblem
from .refit import effective_num_values


def _sweep(alpha, w, d, n, z, N, gamma):
    """One hard-threshold sweep on host lists. Returns (alpha_new,
    max |delta|)."""
    c = S = 0.0
    for a_k, w_k, d_k, n_k in zip(alpha, w, d, n):
        c += a_k * d_k
        S += n_k * (w_k - c)
    c = md = 0.0
    out = []
    for a_old, w_k, d_k, n_k, z_k, N_k in zip(alpha, w, d, n, z, N):
        g = d_k * S + z_k * a_old
        a_new = g / z_k if g * g / (2.0 * z_k) > gamma else 0.0
        delta = a_new - a_old
        S -= delta * d_k * N_k
        c += a_new * d_k
        S -= n_k * (w_k - c)
        out.append(a_new)
        md = max(md, abs(delta))
    return out, md


def l0_sweep(alpha: torch.Tensor, problem: LSQProblem, gamma: float
             ) -> tuple[torch.Tensor, float]:
    """One full hard-threshold sweep. Returns (alpha_new, max |delta|)."""
    cols = map(_host, (problem.w_hat, problem.d, problem.counts, problem.z,
                       problem.n_suffix))
    out, md = _sweep(_host(alpha), *cols, float(gamma))
    return torch.tensor(out, dtype=torch.float32,
                        device=problem.w_hat.device), md


def _solve(cols, gamma: float, alpha: list[float], max_sweeps: int,
           stop: float) -> list[float]:
    sweeps, md = 0, float("inf")
    while sweeps < max_sweeps and md > stop:
        alpha, md = _sweep(alpha, *cols, gamma)
        sweeps += 1
    return alpha


def _stop(w: list[float], tol: float) -> float:
    return tol * max(max((abs(v) for v in w), default=0.0), 1e-12)


def l0_solve(problem: LSQProblem, gamma: float, *,
             alpha0: torch.Tensor | None = None, max_sweeps: int = 100,
             tol: float = 1e-7) -> torch.Tensor:
    """Penalized form at a fixed gamma, from alpha0 (ones by default):
    sweeps until max |delta| <= tol * max |w| or ``max_sweeps``. Returns
    alpha (f32, on the problem's device)."""
    cols = [_host(t) for t in (problem.w_hat, problem.d, problem.counts,
                               problem.z, problem.n_suffix)]
    alpha = [1.0] * problem.m if alpha0 is None else _host(alpha0)
    out = _solve(cols, float(gamma), alpha, max_sweeps, _stop(cols[0], tol))
    return torch.tensor(out, dtype=torch.float32,
                        device=problem.w_hat.device)


def l0_quantize(problem: LSQProblem, l: int, *, bisect_steps: int = 30,
                max_sweeps: int = 100) -> tuple[torch.Tensor, int]:
    """Constrained form: the support of the last bisected gamma whose
    support fits ``l``. Returns (alpha, nnz); nnz may be below l (the
    paper's "non-universal"), or above it where no gamma fit."""
    cols = [_host(t) for t in (problem.w_hat, problem.d, problem.counts,
                               problem.z, problem.n_suffix)]
    w = np.asarray(cols[0])
    n, z = np.asarray(cols[2]), np.asarray(cols[3])
    # above hi every coordinate is pruned on the first sweep: a single
    # coordinate's gain is bounded by the loss at alpha = 0 or by its own
    # z_k / 2 from the alpha = 1 start
    hi = float(np.sum(n * w * w) + 0.5 * z.max() + 1.0)
    lo = 0.0
    stop = _stop(cols[0], 1e-7)

    def solve(gamma):
        # the reference passes gamma as an f32 scalar
        alpha = _solve(cols, float(np.float32(gamma)), [1.0] * problem.m,
                       max_sweeps, stop)
        # support_of on the f32 alpha the caller gets
        return alpha, effective_num_values(
            np.abs(np.asarray(alpha, np.float32)) > 1e-10)

    best = None
    for _ in range(bisect_steps):
        mid = 0.5 * (lo + hi)
        alpha, nnz = solve(mid)
        if nnz <= l:
            best, hi = (alpha, nnz), mid
        else:
            lo = mid
    if best is None:      # even the largest gamma kept more than l values
        best = solve(hi)
    alpha, nnz = best
    return torch.tensor(alpha, dtype=torch.float32,
                        device=problem.w_hat.device), nnz
