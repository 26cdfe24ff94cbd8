"""Problem setup shared by the sparse-LSQ solvers (port of
``repro/core/problem.py``, paper §3.1-3.2).

A vector ``w`` is reduced to its sorted unique values ``w_hat`` with
multiplicities ``counts``. The design matrix V is the lower-triangular
cumulative matrix with column scales d (d_1 = v_1, d_j = v_j - v_{j-1});
it is never materialized:

    (V @ alpha)_i  = cumsum(alpha * d)_i
    ||V[:,k]||^2   = d_k^2 * suffix_count(k)      (paper eq. 12)

``weighted=False`` is the paper's least squares on unique values;
``weighted=True`` weights residuals by multiplicity (the full-vector loss).
As in the reference, the problem is set up in float64 and stored in
float32. Everything stays on the input's device: PTQ on the card runs
the unique pass there.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LSQProblem:
    """Sparse-LSQ problem on sorted unique values (f32 tensors)."""

    w_hat: torch.Tensor      # (m,) sorted unique values
    d: torch.Tensor          # (m,) column scales: d_1 = v_1, d_j = v_j - v_{j-1}
    counts: torch.Tensor     # (m,) multiplicities (all ones if unweighted)
    z: torch.Tensor          # (m,) column norms d_k^2 * N_k
    n_suffix: torch.Tensor   # (m,) suffix count sums N_k = sum_{i>=k} counts_i

    @property
    def m(self) -> int:
        return int(self.w_hat.shape[0])


def _as_f64(a, device=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dtype=torch.float64, device=device)
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)


def unique_with_counts(w) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sorted unique values (f64), multiplicities (f64) and the inverse
    index (int64) of every flat element, on ``w``'s device."""
    flat = _as_f64(w).reshape(-1)
    vals, inverse, counts = torch.unique(flat, sorted=True,
                                         return_inverse=True,
                                         return_counts=True)
    return vals, counts.to(torch.float64), inverse


def make_problem(w_hat, counts=None, *, weighted: bool = False) -> LSQProblem:
    w_hat = _as_f64(w_hat)
    if counts is None or not weighted:
        n = torch.ones_like(w_hat)
    else:
        n = _as_f64(counts, w_hat.device)
    d = torch.diff(w_hat, prepend=w_hat.new_zeros(1))
    n_suffix = torch.flip(torch.cumsum(torch.flip(n, (0,)), 0), (0,))
    z = d * d * n_suffix
    # d_1 = v_1 is 0 when 0.0 is the smallest unique value: a zero column
    # contributes nothing, so its norm is set to 1
    z = torch.where(z <= 0.0, torch.ones_like(z), z)
    f32 = lambda t: t.to(torch.float32)
    return LSQProblem(w_hat=f32(w_hat), d=f32(d), counts=f32(n), z=f32(z),
                      n_suffix=f32(n_suffix))


def reconstruct(alpha: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """w* on unique values: V @ alpha = cumsum(alpha * d) (paper eq. 11)."""
    return torch.cumsum(alpha * d, 0)


def objective(problem: LSQProblem, alpha: torch.Tensor, lam1: float,
              lam2: float = 0.0, *, penalize_first: bool = True
              ) -> torch.Tensor:
    """0.5 * ||sqrt(n) (w_hat - V a)||^2 + lam1 ||a||_1 - lam2 ||a||_2^2."""
    r = problem.w_hat - reconstruct(alpha, problem.d)
    pen = alpha.abs()
    if not penalize_first:
        pen = torch.cat([pen.new_zeros(1), pen[1:]])
    return (0.5 * torch.sum(problem.counts * r * r)
            + lam1 * torch.sum(pen) - lam2 * torch.sum(alpha * alpha))
