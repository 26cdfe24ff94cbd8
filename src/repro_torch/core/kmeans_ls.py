"""Algorithm 3, clustering-based least-square quantization (port of
``repro/core/kmeans_ls.py``; paper eq. 17-20).

k-means on the unique values fixes the cluster membership; the values are
then the exact LS minimisers, which (clusters being intervals in 1-D) are
the segment means ``refit_support`` computes on the support made of each
cluster's first index. ``kmeans_ls_dense_reference`` is the paper's
form: E and V-hat* materialized as eqs. 18-20 and solved by lstsq in
float64 on the host, the oracle the fast path is held to.
"""
from __future__ import annotations

import numpy as np
import torch

from .kmeans import kmeans_1d
from .problem import LSQProblem
from .refit import _f64, refit_support


def kmeans_ls_quantize(problem: LSQProblem, l: int, *, seed: int = 0,
                       restarts: int = 10, max_iter: int = 300):
    """Returns (w_star, alpha_star, assignment, iters)."""
    _, idx, _, iters = kmeans_1d(problem.w_hat, problem.counts, l, seed=seed,
                                 restarts=restarts, max_iter=max_iter)
    # clusters are intervals on the sorted values: each one's first index
    prev = torch.cat([idx.new_full((1,), -1), idx[:-1]])
    w_star, alpha_star = refit_support(problem, idx != prev)
    return w_star, alpha_star, idx, iters


def kmeans_ls_dense_reference(problem: LSQProblem,
                              assignment) -> np.ndarray:
    """Oracle: materialize E and V-hat* exactly as eqs. 18-20 and solve
    (float64 numpy; the reconstruction on unique values)."""
    w, n = _f64(problem.w_hat), _f64(problem.counts)
    idx = _f64(assignment).astype(np.int64)
    l = int(idx.max()) + 1
    m = w.shape[0]
    E = np.zeros((m, l))
    E[np.arange(m), idx] = 1.0
    v = float(np.mean(w))  # paper: fill non-zeros with v = mean(w_hat)
    Vstar = np.tril(np.ones((l, l))) * v
    X = E @ Vstar
    sw = np.sqrt(n)
    coef, *_ = np.linalg.lstsq(X * sw[:, None], w * sw, rcond=None)
    return X @ coef
