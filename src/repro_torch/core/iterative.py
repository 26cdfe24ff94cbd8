"""Algorithm 2: iterative l1 quantization with a lambda ramp (port of
``repro/core/iterative.py:iterative_l1``).

Starts from a small lambda_1^0 and raises it linearly (Delta-lambda =
lambda_1^0), warm-starting alpha from the previous iteration, until
||alpha||_0 <= l; then the Algorithm-1 LS refit. As in the paper it may
end with fewer than l values (§3.5). If the linear ramp has not reached
the budget after ``max_iters``, lambda doubles until it does.
"""
from __future__ import annotations

import numpy as np
import torch

from .cd import cd_solve
from .problem import LSQProblem
from .refit import effective_num_values, refit_support, support_of


def iterative_l1(problem: LSQProblem, l: int, *, lam0: float | None = None,
                 max_iters: int = 60, max_sweeps: int = 200,
                 ) -> tuple[torch.Tensor, torch.Tensor, int, int]:
    """Returns (w_star, alpha_star, nnz, iters)."""
    if lam0 is None:
        # relative to the scale of the objective: a data-independent ramp
        w = problem.w_hat.double()
        n = problem.counts.double()
        lam0 = float(0.005 * torch.sum(n * w * w) / max(int(w.numel()), 1))
    alpha = torch.ones(problem.m, dtype=torch.float32,
                       device=problem.w_hat.device)
    nnz, it, lam_t = problem.m, 0, 0.0

    def solve(lam, alpha):
        # the reference passes lambda as an f32 scalar
        alpha, _ = cd_solve(problem, float(np.float32(lam)), alpha0=alpha,
                            max_sweeps=max_sweeps)
        return alpha, effective_num_values(support_of(alpha))

    for it in range(1, max_iters + 1):
        lam_t = lam0 * it            # lam^t = lam0 + (t - 1) * lam0
        alpha, nnz = solve(lam_t, alpha)
        if nnz <= l:
            break
    while nnz > l:                   # lam -> inf drives alpha -> 0
        it += 1
        lam_t *= 2.0
        alpha, nnz = solve(lam_t, alpha)
    w_star, alpha_star = refit_support(problem, support_of(alpha))
    return w_star, alpha_star, nnz, it
