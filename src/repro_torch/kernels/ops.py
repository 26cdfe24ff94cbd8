"""The batched eq.-6 solve around the FISTA kernel (port of
``repro/kernels/ops.py:power_iter_lipschitz`` and ``solve_fista_batch``):
preconditioning, the step size, padding to the kernel's 128-column blocks
and unpadding. Everything runs on the rows' device; only the power
iteration's start vector is drawn on the host, from the reference's own
generator (``np.random.default_rng(0)``), so both packages start from the
same vector.
"""
from __future__ import annotations

import numpy as np
import torch

from .fista_quant import fista_quant

BLOCK_T = 128           # the kernel's column block (the reference's lanes)


def power_iter_lipschitz(d: torch.Tensor, n: torch.Tensor,
                         iters: int = 50) -> torch.Tensor:
    """sigma_max(diag(sqrt(n)) V)^2 per row by power iteration, in float64
    as in the reference. d, n: (B, M). V is applied by cumsum and suffix
    sum, O(B*M) per iteration. Returns (B,) float64."""
    B, M = d.shape
    d, n = d.double(), n.double()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(B, M))).to(
        d.device)
    x = x / (torch.linalg.norm(x, dim=1, keepdim=True) + 1e-30)
    lam = torch.ones(B, dtype=torch.float64, device=d.device)
    for _ in range(iters):
        v = torch.cumsum(x * d, dim=1) * n                 # diag(n) V x
        cums = torch.cumsum(v, dim=1)
        y = d * (cums[:, -1:] - cums + v)                  # V^T diag(n) V x
        lam = torch.clamp_min((x * y).sum(1), 1e-30)
        x = y / (torch.linalg.norm(y, dim=1, keepdim=True) + 1e-30)
    return lam              # the Rayleigh quotient at convergence = L


def fista_batch_problem(w_rows: torch.Tensor, d_rows: torch.Tensor,
                        n_rows: torch.Tensor, lam) -> dict:
    """The kernel's inputs for ``solve_fista_batch``: w, d, n, lam padded
    to (B, nb, 128) blocks with the columns preconditioned to unit norm
    (alpha_bar = sqrt(z) alpha, thresholds lam / sqrt(z): the same
    problem, a ~14x lower Lipschitz constant, the reference's
    measurement), the step size ``eta`` (B, 1, 1) and the column
    ``scale`` (B, M) that undoes the preconditioning."""
    B, M = w_rows.shape
    dev = w_rows.device
    n_rows = n_rows.float()
    lam_rows = torch.as_tensor(lam, dtype=torch.float32, device=dev).reshape(
        -1, 1).expand(B, M).clone()
    lam_rows[n_rows == 0] = 0.0              # padding: no penalty
    nsuf = torch.flip(torch.cumsum(torch.flip(n_rows, (1,)), 1), (1,))
    d_rows = d_rows.float()
    z = d_rows * d_rows * nsuf
    scale = torch.sqrt(torch.where(z <= 0, torch.ones_like(z), z))
    d_rows = d_rows / scale
    L = power_iter_lipschitz(d_rows, n_rows)
    pad = (-M) % BLOCK_T
    blk = lambda a: torch.nn.functional.pad(a.float(), (0, pad)).reshape(
        B, -1, BLOCK_T)
    return dict(w=blk(w_rows), d=blk(d_rows), n=blk(n_rows),
                lam=blk(lam_rows / scale),
                eta=(1.0 / (L * 1.01)).float().reshape(B, 1, 1), scale=scale)


def solve_fista_batch(w_rows: torch.Tensor, d_rows: torch.Tensor,
                      n_rows: torch.Tensor, lam, *,
                      n_iters: int = 300) -> torch.Tensor:
    """Batched eq.-6 solve: alpha (B, M) f32 on the rows' device.

    w_rows (B, M) sorted unique values, zero-padded; d_rows column scales
    and n_rows weights, both 0 on padding; lam a scalar or (B,) penalty.
    One kernel launch for all rows (``fista_batch_problem`` sets it up);
    padding columns come back 0."""
    M = w_rows.shape[1]
    p = fista_batch_problem(w_rows, d_rows, n_rows, lam)
    alpha = fista_quant(p["w"], p["d"], p["n"], p["lam"], p["eta"],
                        n_iters=n_iters)
    alpha = alpha.reshape(alpha.shape[0], -1)[:, :M] / p["scale"]
    return torch.where(n_rows == 0, torch.zeros_like(alpha), alpha)
