"""Mixture-of-Gaussians quantization baseline (port of
``repro/core/mog.py``; paper §2, refs [15][16]).

A 1-D GMM fit by EM on (unique values, multiplicities), started from
``kmeans_1d(..., restarts=4)``'s centers; each value is quantized to the
mean of its most likely component (hard assignment after EM). Torch on
the values' device, in f32 as the reference's jit. The k-means++ seeding
draws from a ``torch.Generator`` (``core.kmeans``), so the fit differs
from the reference's on the same seed; from the same centers it is the
same EM.
"""
from __future__ import annotations

import math

import torch

from .kmeans import kmeans_1d


def _log_lik(vals, mu, var, pi):
    return (torch.log(pi.clamp_min(1e-20))[None, :]
            - 0.5 * torch.log(2 * math.pi * var)[None, :]
            - 0.5 * (vals[:, None] - mu[None, :]) ** 2 / var[None, :])


def mog_quantize_unique(vals: torch.Tensor, counts: torch.Tensor, k: int, *,
                        seed: int = 0, n_iter: int = 100):
    """Returns (recon (m,), assignment (m,), means (k,))."""
    vals, counts = vals.float(), counts.float()
    mu, _, _, _ = kmeans_1d(vals, counts, k, seed=seed, restarts=4)
    n_tot = counts.sum()
    mean = (counts * vals).sum() / n_tot
    var0 = ((counts * (vals - mean) ** 2).sum() / n_tot).clamp_min(1e-12)
    var = (var0 / k).expand(k)
    pi = torch.full((k,), 1.0 / k, device=vals.device)
    for _ in range(n_iter):
        # E-step in the log domain, counts as fractional repetitions
        logp = _log_lik(vals, mu, var, pi)
        logr = logp - torch.logsumexp(logp, dim=1, keepdim=True)
        r = torch.exp(logr) * counts[:, None]
        nk = r.sum(0).clamp_min(1e-12)
        mu = (r * vals[:, None]).sum(0) / nk
        var = ((r * (vals[:, None] - mu[None, :]) ** 2).sum(0)
               / nk).clamp_min(1e-12)
        pi = nk / nk.sum()
    idx = torch.argmax(_log_lik(vals, mu, var, pi), dim=1)
    return mu[idx], idx, mu
