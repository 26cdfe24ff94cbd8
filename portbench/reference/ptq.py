"""A frozen copy of the kmeans_ls post-training quantization of one
projection, as the configuration's ``ptq: kmeans_ls@16`` states it: the
paper's Algorithm 3 on the sorted unique values of the weight.

Weighted k-means++ seeding (``restarts`` restarts drawn from a
``torch.Generator`` seeded with the spec's seed, 0) and Lloyd's
iterations over the unique values (unweighted: each unique value counts
once, as ``kmeans_ls@16`` without ``weighted=true``) fix the clusters;
each cluster's value is then the least-squares value, the mean of its
unique values (eqs. 17-20). Plain torch, copied from the program's
``core/problem.py``, ``core/kmeans.py``, ``core/kmeans_ls.py``,
``core/refit.py`` and ``core/types.py:from_dense`` so that the reference
works the codes out again on its own: on the same device it draws the
program's numbers.
"""
from __future__ import annotations

import torch


def _prefix(counts, vals):
    zero = vals.new_zeros(1, dtype=torch.float64)
    n, v = counts.double(), vals.double()
    return (torch.cat([zero, torch.cumsum(n * v, 0)]),
            torch.cat([zero, torch.cumsum(n, 0)]))


def _lloyd(vals, counts, c0, max_iter, tol, check_every=8):
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
            b = torch.searchsorted(vals, mid.contiguous(), right=True)
            b = torch.cat([bounds, b, last], dim=1)
            num = num_cs[b[:, 1:]] - num_cs[b[:, :-1]]
            den = den_cs[b[:, 1:]] - den_cs[b[:, :-1]]
            new = torch.where(den > 0, num / den.clamp(min=1e-20),
                              centers.double()).to(centers.dtype)
            new = torch.sort(new, dim=1).values
            prev = torch.where(run[:, None], centers, prev)
            centers = torch.where(run[:, None], new, centers)
            iters = iters + run.to(torch.int32)
            run = active()
    mid = 0.5 * (centers[..., 1:] + centers[..., :-1])
    v = vals.expand(mid.shape[:-1] + vals.shape[-1:]).contiguous()
    idx = torch.searchsorted(mid.contiguous(), v, right=False)
    resid = vals.double() - torch.gather(centers, 1, idx).double()
    inertia = torch.sum(counts.double() * resid * resid, dim=1)
    return idx, inertia


def _kmeanspp(vals, counts, k, R, gen):
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


def quantize_weight(w: torch.Tensor, num_values: int, *, seed: int = 0,
                    restarts: int = 10, max_iter: int = 300,
                    tol: float = 1e-7) -> tuple[torch.Tensor, torch.Tensor]:
    """(codebook (L,) f32 sorted, codes of ``w``'s shape int64)."""
    flat = w.reshape(-1).to(torch.float64)
    vals64, inverse = torch.unique(flat, sorted=True, return_inverse=True)
    w_hat = vals64.to(torch.float32)
    ones = torch.ones_like(w_hat)
    L = int(min(num_values, w_hat.shape[0]))
    vals = w_hat.contiguous()
    gen = torch.Generator(device=vals.device).manual_seed(seed)
    c0 = _kmeanspp(vals, ones, L, restarts, gen)
    idx, inertia = _lloyd(vals, ones, c0, max_iter, tol)
    idx = idx[int(torch.argmin(inertia))]
    # clusters are intervals on the sorted values: refit each to the mean
    # of its unique values (the least-squares value on that support)
    start = torch.cat([idx.new_full((1,), -1), idx[:-1]]) != idx
    recon = _segment_means(w_hat.double(), start)
    codebook, code_of_unique = torch.unique(recon, sorted=True,
                                            return_inverse=True)
    codes = code_of_unique[inverse].reshape(w.shape)
    return codebook.to(torch.float32), codes


def _segment_means(w: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """Each value replaced by the mean of its segment (segments start at
    ``support``), rounded through f32 as the program stores it."""
    m = w.shape[0]
    pos = torch.arange(m, device=w.device)
    start = torch.cummax(torch.where(support, pos, -1), 0).values
    nxt = torch.where(support, pos, m)
    end = torch.flip(torch.cummin(torch.flip(
        torch.cat([nxt[1:], nxt.new_full((1,), m)]), (0,)), 0).values, (0,))
    s = start.clamp(min=0)
    zero = w.new_zeros(1)
    num = torch.cat([zero, torch.cumsum(w, 0)])
    den = torch.cat([zero, torch.cumsum(torch.ones_like(w), 0)])
    means = (num[end] - num[s]) / (den[end] - den[s]).clamp(min=1e-20)
    return means.to(torch.float32).to(torch.float64)
