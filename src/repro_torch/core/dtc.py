"""Data-transformation clustering baseline (port of ``repro/core/dtc.py``;
paper ref [9], Azimi et al. 2017).

The 1-D specialisation of clustering after a density-equalising
transform: a weighted quantile (midpoint-rank) transform maps the values
to [0, 1], ``kmeans_1d(..., restarts=4)`` clusters there (near
equal-frequency intervals), and each cluster's representative is the
count-weighted mean of its original values. Torch on the values'
device. The clusters are intervals of the sorted values, so their sums
are differences of one float64 prefix sum (no atomics: the same bits on
every run), where the reference sums segments in f32. The k-means++
seeding draws from a ``torch.Generator``, so clusters differ from the
reference's on the same seed.
"""
from __future__ import annotations

import torch

from .kmeans import kmeans_1d


def dtc_quantize_unique(vals: torch.Tensor, counts: torch.Tensor, k: int, *,
                        seed: int = 0):
    """Returns (recon (m,), assignment (m,), centers (k,))."""
    vals, counts = vals.float(), counts.float()
    cum = torch.cumsum(counts, 0)
    u = (cum - 0.5 * counts) / cum[-1].clamp_min(1e-20)
    _, idx, _, _ = kmeans_1d(u, counts, k, seed=seed, restarts=4)
    # idx ascends along the sorted values: cluster j is [b_j, b_{j+1})
    b = torch.searchsorted(idx, torch.arange(k + 1, device=idx.device))
    zero = vals.new_zeros(1, dtype=torch.float64)
    num = torch.cat([zero, torch.cumsum(counts.double() * vals.double(), 0)])
    den = torch.cat([zero, torch.cumsum(counts.double(), 0)])
    num, den = num[b[1:]] - num[b[:-1]], den[b[1:]] - den[b[:-1]]
    centers = torch.where(den > 0, num / den.clamp_min(1e-20),
                          torch.zeros_like(num)).float()
    return centers[idx], idx, centers
