"""Algorithm 3, clustering-based least-square quantization (port of
``repro/core/kmeans_ls.py``; paper eq. 17-20).

k-means on the unique values fixes the cluster membership; the values are
then the exact LS minimisers, which (clusters being intervals in 1-D) are
the segment means ``refit_support`` computes on the support made of each
cluster's first index.
"""
from __future__ import annotations

import torch

from .kmeans import kmeans_1d
from .problem import LSQProblem
from .refit import refit_support


def kmeans_ls_quantize(problem: LSQProblem, l: int, *, seed: int = 0,
                       restarts: int = 10, max_iter: int = 300):
    """Returns (w_star, alpha_star, assignment, iters)."""
    _, idx, _, iters = kmeans_1d(problem.w_hat, problem.counts, l, seed=seed,
                                 restarts=restarts, max_iter=max_iter)
    # clusters are intervals on the sorted values: each one's first index
    prev = torch.cat([idx.new_full((1,), -1), idx[:-1]])
    w_star, alpha_star = refit_support(problem, idx != prev)
    return w_star, alpha_star, idx, iters
