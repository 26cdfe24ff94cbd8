"""Coordinate descent for the paper's l1 / l1+l2 objectives (port of
``repro/core/cd.py``; paper eq. 6, 13-15, Algorithm 1).

Exact cyclic coordinate descent with an O(m) sweep, using the cumulative
structure of V: sweeping k = 1..m, carry

    S = sum_{i>=k} n_i r_i        (weighted suffix residual sum)
    c = sum_{j<=k-1} a_j^new d_j  (running reconstruction prefix)

then per coordinate, in O(1):

    g   = d_k S + z_k a_k
    a_k <- S_{lam1}(g) / (z_k - 2 lam2)            (eq. 14; eq. 15 if lam2)
    S <- S - delta d_k N_k ;  c <- c + a_k d_k ;  S <- S - n_k (w_k - c)

The sweep is a sequential scan, the host path of the paper's solver (the
batched device path is FISTA, ``kernels.fista_quant``). It runs as a loop
over Python floats (float64) on a host copy of the problem and returns
f32 tensors on the problem's device; the reference scans in f32, so the
two agree to f32 rounding, not bitwise.
"""
from __future__ import annotations

import numpy as np
import torch

from .problem import LSQProblem


def _host(t: torch.Tensor) -> list[float]:
    return t.detach().to("cpu", torch.float64).tolist()


def _soft(g: float, lam: float) -> float:
    m = abs(g) - lam
    if m <= 0.0:
        return 0.0
    return m if g > 0 else -m


def _sweep(alpha, w, d, n, z, N, lam1, den):
    """One cyclic sweep on host lists. Returns (alpha_new, max |delta|)."""
    c = S = 0.0
    for a_k, w_k, d_k, n_k in zip(alpha, w, d, n):
        c += a_k * d_k
        S += n_k * (w_k - c)
    c = md = 0.0
    out = []
    for a_old, w_k, d_k, n_k, z_k, N_k, l_k, den_k in zip(
            alpha, w, d, n, z, N, lam1, den):
        a_new = _soft(d_k * S + z_k * a_old, l_k) / den_k
        delta = a_new - a_old
        S -= delta * d_k * N_k           # residual suffix update (column k)
        c += a_new * d_k                 # reconstruction prefix
        S -= n_k * (w_k - c)             # drop row k from the suffix
        out.append(a_new)
        md = max(md, abs(delta))
    return out, md


def _lam_vec(m: int, lam1: float, penalize_first: bool) -> list[float]:
    lam = [float(lam1)] * m
    if not penalize_first and m:
        lam[0] = 0.0
    return lam


def cd_sweep(alpha: torch.Tensor, problem: LSQProblem,
             lam1_vec: torch.Tensor, lam2: float
             ) -> tuple[torch.Tensor, float]:
    """One full cyclic CD sweep. Returns (alpha_new, max |delta|)."""
    w, d, n, z, N = map(_host, (problem.w_hat, problem.d, problem.counts,
                                problem.z, problem.n_suffix))
    den = [z_k - 2.0 * float(lam2) for z_k in z]
    out, md = _sweep(_host(alpha), w, d, n, z, N, _host(lam1_vec), den)
    return torch.tensor(out, dtype=torch.float32,
                        device=problem.w_hat.device), md


def cd_solve(problem: LSQProblem, lam1: float, lam2: float = 0.0, *,
             alpha0: torch.Tensor | None = None, max_sweeps: int = 200,
             tol: float = 1e-7, penalize_first: bool = True
             ) -> tuple[torch.Tensor, int]:
    """Solve eq. 6 (lam2 = 0) or eq. 13 (lam2 > 0) by cyclic CD.

    Returns (alpha, n_sweeps); alpha (f32, on the problem's device) has
    exact zeros on the pruned support. alpha0 = ones (the default) starts
    at zero LS loss (paper §3.2.1)."""
    m = problem.m
    w, d, n, z, N = map(_host, (problem.w_hat, problem.d, problem.counts,
                                problem.z, problem.n_suffix))
    alpha = [1.0] * m if alpha0 is None else _host(alpha0)
    lam = _lam_vec(m, lam1, penalize_first)
    den = [z_k - 2.0 * float(lam2) for z_k in z]
    # tolerance relative to the data, so convergence is size-independent
    stop = tol * max(max((abs(v) for v in w), default=0.0), 1e-12)
    sweeps, md = 0, float("inf")
    while sweeps < max_sweeps and md > stop:
        alpha, md = _sweep(alpha, w, d, n, z, N, lam, den)
        sweeps += 1
    return torch.tensor(alpha, dtype=torch.float32,
                        device=problem.w_hat.device), sweeps


def max_stable_lam2(problem: LSQProblem) -> float:
    """Largest lam2 keeping eq. 13 coordinate-wise convex:
    lam2 < min_k z_k / 2."""
    return float(0.5 * problem.z.min())


def cd_solve_dense_reference(problem: LSQProblem, lam1: float,
                             lam2: float = 0.0, *,
                             alpha0: np.ndarray | None = None,
                             max_sweeps: int = 200, tol: float = 1e-7,
                             penalize_first: bool = True,
                             ) -> tuple[np.ndarray, int]:
    """Naive O(m^2)-per-sweep CD on the materialized V (float64 numpy).
    The test oracle."""
    w, d, n = (np.asarray(_host(t)) for t in (problem.w_hat, problem.d,
                                               problem.counts))
    m = w.shape[0]
    V = np.tril(np.ones((m, m))) * d[None, :]
    z = (V * V * n[:, None]).sum(0)
    z = np.where(z <= 0, 1.0, z)
    alpha = np.ones(m) if alpha0 is None else np.array(alpha0, np.float64)
    lam1v = np.asarray(_lam_vec(m, lam1, penalize_first))
    scale = max(np.abs(w).max(), 1e-12)
    for sweep in range(max_sweeps):
        max_delta = 0.0
        r = w - V @ alpha
        for k in range(m):
            g = (V[:, k] * n) @ r + z[k] * alpha[k]
            a_new = np.sign(g) * max(abs(g) - lam1v[k], 0.0) / (
                z[k] - 2.0 * lam2)
            delta = a_new - alpha[k]
            r = r - V[:, k] * delta
            alpha[k] = a_new
            max_delta = max(max_delta, abs(delta))
        if max_delta <= tol * scale:
            break
    return alpha, sweep + 1
