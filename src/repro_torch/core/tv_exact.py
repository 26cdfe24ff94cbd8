"""Exact O(m) solver of the paper's eq. 6 through its weighted-TV form
(port of ``repro/core/tv_exact.py``; beyond the paper).

Substituting beta = alpha * d turns the l1 objective into a weighted 1-D
fused-lasso (total-variation) problem on the sorted unique values

    min_u  1/2 sum_i n_i (w_hat_i - u_i)^2  +  lam * sum_{j>=2} |u_j - u_{j-1}| / d_j

(without the paper's lam |alpha_1| term: ``cd_solve(...,
penalize_first=False)`` solves the same objective). N. A. Johnson's
dynamic programming (2013), with per-point weights and per-edge
penalties, finds the global optimum with no iterations.

A host solve over Python floats (IEEE doubles: the reference's numpy
float64 operations in its order), O(m) time and memory. Returns float64
tensors on the input's device.
"""
from __future__ import annotations

import numpy as np
import torch

from .problem import LSQProblem


def _host(a) -> list[float]:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).tolist()
    return np.asarray(a, np.float64).tolist()


def _tv1d(y: list[float], w: list[float], lam_edges: list[float]
          ) -> list[float]:
    n = len(y)
    if n == 1:
        return list(y)
    SZ = 2 * n
    x, a, b = [0.0] * SZ, [0.0] * SZ, [0.0] * SZ
    tm, tp = [0.0] * (n - 1), [0.0] * (n - 1)

    lam = lam_edges[0]
    tm[0] = y[0] - lam / w[0]
    tp[0] = y[0] + lam / w[0]
    l, r = n - 1, n
    x[l], x[r] = tm[0], tp[0]
    a[l], b[l] = w[0], -w[0] * y[0] + lam
    a[r], b[r] = -w[0], w[0] * y[0] + lam
    afirst, bfirst = w[1], -w[1] * y[1] - lam
    alast, blast = -w[1], w[1] * y[1] - lam   # negated right-side line

    for k in range(1, n - 1):
        lam = lam_edges[k]
        # left threshold: the first point where the derivative exceeds -lam
        alo, blo = afirst, bfirst
        lo = l
        while lo <= r and alo * x[lo] + blo < -lam:
            alo += a[lo]
            blo += b[lo]
            lo += 1
        # right threshold: the last point (from the right) where it is < lam
        ahi, bhi = alast, blast
        hi = r
        while hi >= lo and -(ahi * x[hi] + bhi) > lam:
            ahi += a[hi]
            bhi += b[hi]
            hi -= 1
        tm[k] = (-lam - blo) / alo
        tp[k] = -(lam + bhi) / ahi
        l, r = lo - 1, hi + 1
        x[l], x[r] = tm[k], tp[k]
        a[l], b[l] = alo, blo + lam
        a[r], b[r] = ahi, bhi + lam
        afirst, bfirst = w[k + 1], -w[k + 1] * y[k + 1] - lam
        alast, blast = -w[k + 1], w[k + 1] * y[k + 1] - lam

    # minimise the final message: the root of its derivative
    alo, blo = afirst, bfirst
    lo = l
    while lo <= r and alo * x[lo] + blo < 0.0:
        alo += a[lo]
        blo += b[lo]
        lo += 1
    u = [0.0] * n
    u[n - 1] = -blo / alo
    for k in range(n - 2, -1, -1):
        u[k] = min(max(u[k + 1], tm[k]), tp[k])
    return u


def tv1d_weighted(y, w, lam_edges) -> torch.Tensor:
    """min_u 1/2 sum w_i (y_i - u_i)^2 + sum_k lam_edges[k] |u_{k+1} - u_k|.

    y, w: (n,); lam_edges: (n-1,) nonnegative. Returns u (n,) float64 on
    ``y``'s device. Derivative-knot DP: the messages are convex
    piecewise quadratics whose derivatives are piecewise linear, kept as
    a base line plus per-knot (slope, intercept) increments; each
    inf-convolution with lam |.| clips the derivative at +-lam, recorded
    as back-pointer thresholds (tm, tp)."""
    dev = y.device if isinstance(y, torch.Tensor) else "cpu"
    u = _tv1d(_host(y), _host(w), _host(lam_edges))
    return torch.tensor(u, dtype=torch.float64, device=dev)


def tv_solve_problem(problem: LSQProblem, lam: float) -> torch.Tensor:
    """The exact solution u of eq. 6 (penalize_first=False) on a problem:
    float64 (m,) on the problem's device."""
    y, n, d = (_host(t) for t in (problem.w_hat, problem.counts, problem.d))
    lam_edges = [lam / max(abs(g), 1e-30) for g in d[1:]]
    return torch.tensor(_tv1d(y, n, lam_edges), dtype=torch.float64,
                        device=problem.w_hat.device)


def tv_support(u: torch.Tensor) -> torch.Tensor:
    """The support of a TV solution: where u jumps (u_0 jumps from 0)."""
    return torch.diff(u, prepend=u.new_zeros(1)).abs() > 1e-10
