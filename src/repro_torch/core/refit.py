"""Least-square refit on a support (port of ``repro/core/refit.py``; paper
eq. 7-10, Algorithm 1 steps 3-5).

The selected columns of V span piecewise-constant vectors with breakpoints
at the support indices, so the LS refit is closed-form: each segment's
value is the (count-weighted) mean of w_hat over it. Rows before the first
support index reconstruct to 0, as in the paper's V* formulation.

Segments are contiguous, so their sums are differences of one float64
prefix sum: deterministic on the card (no atomics) and more accurate than
the reference's float32 segment sums, which it matches to ~1e-7 relative.
"""
from __future__ import annotations

import numpy as np
import torch

from .problem import LSQProblem


def refit_support(problem: LSQProblem, support: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Optimal piecewise-constant reconstruction for a boolean support.

    Returns (w_star, alpha_star): the reconstruction on unique values (m,)
    and the refit alpha (eq. 10; zeros off the support), both f32.
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
                         torch.zeros_like(w)).to(torch.float32)
    # alpha* (eq. 10): jump sizes at support positions scaled by 1/d_k
    prev = torch.cat([w_star.new_zeros(1), w_star[:-1]])
    jump = w_star - prev
    d = problem.d
    d_safe = torch.where(d == 0, torch.ones_like(d), d)
    alpha_star = torch.where(support, jump / d_safe, torch.zeros_like(jump))
    return w_star, alpha_star


def support_of(alpha: torch.Tensor, tol: float = 1e-10) -> torch.Tensor:
    return alpha.abs() > tol


def effective_num_values(support) -> int:
    """Distinct values of the reconstruction for a support mask: if index
    0 is off the support, the rows before the first support index
    reconstruct to the extra value 0."""
    s = (support.cpu().numpy() if isinstance(support, torch.Tensor)
         else np.asarray(support))
    return int(s.sum()) + (0 if (s.size and s[0]) else 1)
