"""Least-square refit on a support (port of ``repro/core/refit.py``; paper
eq. 7-10, Algorithm 1 steps 3-5).

The selected columns of V span piecewise-constant vectors with breakpoints
at the support indices, so the LS refit is closed-form: each segment's
value is the (count-weighted) mean of w_hat over it. Rows before the first
support index reconstruct to 0, as in the paper's V* formulation.

Segments are contiguous, so their sums are differences of one float64
prefix sum: deterministic on the card (no atomics) and more accurate than
the reference's float32 segment sums, which it matches to ~1e-7 relative.
``refit_support_dense_reference`` is the paper's own form, eq. 9 solved
by lstsq on the materialized V*, in float64 on the host: the oracle the
closed form is held to.
"""
from __future__ import annotations

import numpy as np
import torch

from .problem import LSQProblem


def refit_support(problem: LSQProblem, support: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Optimal piecewise-constant reconstruction for a boolean support.

    Returns (w_star, alpha_star): the reconstruction on unique values (m,)
    and the refit alpha (eq. 10; zeros off the support), in the
    problem's dtype (f32 as ``make_problem`` stores it; a float64 problem
    gives the float64 solution the oracle is held to).
    """
    w, n = problem.w_hat.double(), problem.counts.double()
    support = support.to(device=w.device, dtype=torch.bool)
    m = w.shape[0]
    pos = torch.arange(m, device=w.device)
    # segment of i: [start_i, end_i), start_i = last support index <= i
    # (-1 before the first), end_i = first support index > i (m after the
    # last)
    start = torch.cummax(torch.where(support, pos, -1), 0).values
    nxt = torch.where(support, pos, m)
    end = torch.flip(torch.cummin(torch.flip(
        torch.cat([nxt[1:], nxt.new_full((1,), m)]), (0,)), 0).values, (0,))
    valid = start >= 0
    s = start.clamp(min=0)
    zero = w.new_zeros(1)
    num = torch.cat([zero, torch.cumsum(n * w, 0)])
    den = torch.cat([zero, torch.cumsum(n, 0)])
    seg_num = num[end] - num[s]
    seg_den = den[end] - den[s]
    w_star = torch.where(valid, seg_num / seg_den.clamp(min=1e-20),
                         torch.zeros_like(w)).to(problem.w_hat.dtype)
    # alpha* (eq. 10): jump sizes at support positions scaled by 1/d_k
    prev = torch.cat([w_star.new_zeros(1), w_star[:-1]])
    jump = w_star - prev
    d = problem.d
    d_safe = torch.where(d == 0, torch.ones_like(d), d)
    alpha_star = torch.where(support, jump / d_safe, torch.zeros_like(jump))
    return w_star, alpha_star


def refit_support_dense_reference(problem: LSQProblem,
                                  support) -> np.ndarray:
    """Oracle: materialize V*, solve eq. 9 by lstsq (float64 numpy; the
    reconstruction on unique values). Tests only."""
    w, d, n = (_f64(t) for t in (problem.w_hat, problem.d, problem.counts))
    m = w.shape[0]
    V = np.tril(np.ones((m, m))) * d[None, :]
    Vs = V[:, _f64(support).astype(bool)]
    sw = np.sqrt(n)
    coef, *_ = np.linalg.lstsq(Vs * sw[:, None], w * sw, rcond=None)
    return Vs @ coef


def _f64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().double().numpy()
    return np.asarray(t, np.float64)


def support_of(alpha: torch.Tensor, tol: float = 1e-10) -> torch.Tensor:
    return alpha.abs() > tol


def effective_num_values(support) -> int:
    """Distinct values of the reconstruction for a support mask: if index
    0 is off the support, the rows before the first support index
    reconstruct to the extra value 0."""
    s = (support.cpu().numpy() if isinstance(support, torch.Tensor)
         else np.asarray(support))
    return int(s.sum()) + (0 if (s.size and s[0]) else 1)
