"""1-D (weighted) k-means (port of ``repro/core/kmeans.py``), the paper's
main baseline and Algorithm 3's clustering step.

The data are sorted unique values with multiplicities, so clusters are
intervals: assignment is a searchsorted against the centroid midpoints
(left side, as ``jnp.searchsorted``), and a cluster's sums are differences
of float64 prefix sums at its interval bounds, O(k log m) per iteration
instead of O(m). Weighted k-means++ seeding, ``restarts`` restarts as a
batch dimension, the best kept by inertia; empty clusters keep their
previous centroid.

Each restart stops on its own, as the reference's ``vmap(while_loop)``
does: a restart whose centers moved by at most ``tol`` (or that reached
``max_iter``) keeps its state while the others iterate. The host checks
whether any restart is still running once every ``check_every``
iterations, not every iteration: a stopped restart is frozen by the mask,
so the extra iterations change nothing.

Seeding draws from a ``torch.Generator``; jax.random draws other numbers
from the same seed, so codebooks differ from the reference's while their
loss matches (tests/test_torch_quant.py). ``_lloyd`` from the same initial
centers is deterministic and matches the reference.
"""
from __future__ import annotations

import torch


def _assign(vals: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Cluster id per value, given sorted centers (..., k): the number of
    midpoints strictly below the value."""
    mid = 0.5 * (centers[..., 1:] + centers[..., :-1])
    v = vals.expand(mid.shape[:-1] + vals.shape[-1:]).contiguous()
    return torch.searchsorted(mid.contiguous(), v, right=False)


def _prefix(counts: torch.Tensor, vals: torch.Tensor):
    """float64 prefix sums of counts*vals and counts, with a leading 0."""
    zero = vals.new_zeros(1, dtype=torch.float64)
    n, v = counts.double(), vals.double()
    return (torch.cat([zero, torch.cumsum(n * v, 0)]),
            torch.cat([zero, torch.cumsum(n, 0)]))


def _lloyd(vals: torch.Tensor, counts: torch.Tensor, centers0: torch.Tensor,
           max_iter: int, tol: float, *, check_every: int = 8):
    """Lloyd iterations from ``centers0`` (R, k) (or (k,)), one stop per
    restart. Returns (centers, assignment, inertia, iters), batched like
    ``centers0``."""
    single = centers0.dim() == 1
    c0 = centers0[None] if single else centers0
    R, k = c0.shape
    m = vals.shape[0]
    num_cs, den_cs = _prefix(counts, vals)
    centers = torch.sort(c0, dim=1).values
    prev = c0 + torch.inf
    iters = torch.zeros(R, dtype=torch.int32, device=vals.device)
    bounds = vals.new_full((R, 1), 0, dtype=torch.int64)
    last = vals.new_full((R, 1), m, dtype=torch.int64)

    def active():
        moved = (centers - prev).abs().amax(dim=1) > tol
        return moved & (iters < max_iter)

    run = active()
    while bool(run.any()):
        for _ in range(check_every):
            mid = 0.5 * (centers[:, 1:] + centers[:, :-1])
            # cluster j+1 starts after the last value <= mid_j
            b = torch.searchsorted(vals, mid.contiguous(), right=True)
            b = torch.cat([bounds, b, last], dim=1)            # (R, k+1)
            num = num_cs[b[:, 1:]] - num_cs[b[:, :-1]]
            den = den_cs[b[:, 1:]] - den_cs[b[:, :-1]]
            new = torch.where(den > 0, num / den.clamp(min=1e-20),
                              centers.double()).to(centers.dtype)
            new = torch.sort(new, dim=1).values
            prev = torch.where(run[:, None], centers, prev)
            centers = torch.where(run[:, None], new, centers)
            iters = iters + run.to(torch.int32)
            run = active()
    idx = _assign(vals, centers)                               # (R, m)
    resid = vals.double() - torch.gather(centers, 1, idx).double()
    inertia = torch.sum(counts.double() * resid * resid, dim=1)
    if single:
        return centers[0], idx[0], inertia[0], iters[0]
    return centers, idx, inertia, iters


def _kmeanspp(vals: torch.Tensor, counts: torch.Tensor, k: int, R: int,
              gen: torch.Generator) -> torch.Tensor:
    """Weighted k-means++ seeding for R restarts at once -> (R, k)."""
    w0 = counts.clamp(min=1e-20).expand(R, -1).contiguous()
    first = torch.multinomial(w0, 1, generator=gen)[:, 0]
    pick = vals[first]
    centers = pick[:, None].repeat(1, k)
    d2 = (vals[None] - pick[:, None]) ** 2
    for i in range(1, k):
        w = (counts[None] * d2).clamp(min=1e-30)
        nxt = torch.multinomial(w, 1, generator=gen)[:, 0]
        pick = vals[nxt]
        centers[:, i] = pick
        d2 = torch.minimum(d2, (vals[None] - pick[:, None]) ** 2)
    return centers


def kmeans_1d(vals: torch.Tensor, counts: torch.Tensor, k: int, *,
              seed: int = 0, restarts: int = 10, max_iter: int = 300,
              tol: float = 1e-7):
    """Weighted 1-D k-means. Returns (centers (k,), assignment (m,),
    inertia, iters summed over restarts).

    ``vals`` must be sorted ascending (unique values); ``counts`` are
    multiplicities (ones for the paper's unweighted setting)."""
    vals = vals.to(torch.float32).contiguous()
    counts = counts.to(torch.float32)
    gen = torch.Generator(device=vals.device).manual_seed(seed)
    c0 = _kmeanspp(vals, counts, k, restarts, gen)
    centers, idx, inertia, iters = _lloyd(vals, counts, c0, max_iter, tol)
    best = int(torch.argmin(inertia))
    return centers[best], idx[best], inertia[best], int(iters.sum())


def kmeans_quantize_unique(vals, counts, k: int, *, seed: int = 0,
                           restarts: int = 10, max_iter: int = 300):
    """Reconstruction on unique values using plain k-means centroids."""
    centers, idx, inertia, iters = kmeans_1d(
        vals, counts, k, seed=seed, restarts=restarts, max_iter=max_iter)
    return centers[idx], idx, centers, inertia, iters
