"""A frozen copy of the exact-sketch kmeans_ls page freeze: the paper's
Algorithm 3 over every (page, layer, k/v) row of a KV page, as the
configuration's ``kv_quant: kmeans_ls@16`` states it.

Each row is sketched to ``4 L`` equal-mass quantiles (both extremes
included); the exact dynamic program for 1-D k-means on the sketch gives
the ``L`` centers (deterministic: O(1) interval costs from prefix sums);
every value of the row goes to its nearest center (midpoint intervals),
and each center is refit to the mean of its values (the least-squares
values, eqs. 17-20). Plain torch, copied from the program's
``kernels/page_quant.py:quantize_pages_device`` (with ``ref.scan``) so
that the reference works the pages out again on its own.
"""
from __future__ import annotations

import torch

_BIG = 1e30
_SCAN_BLOCK = 16


def _scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along dim 1 by doubling (fixed order)."""
    R, N = x.shape
    zeros = x.new_zeros((R, N))
    k = 1
    while k < N:
        x = x + torch.cat([zeros[:, :k], x[:, :N - k]], dim=1)
        k *= 2
    return x


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum along dim 1: sequential inside 16-wide
    blocks, block totals scanned recursively and added back."""
    R, N = x.shape
    if N <= _SCAN_BLOCK:
        out = x.clone()
        for i in range(1, N):
            out[:, i] += out[:, i - 1]
        return out
    n = -(-N // _SCAN_BLOCK)
    xb = torch.zeros((R, n * _SCAN_BLOCK), dtype=x.dtype, device=x.device)
    xb[:, :N] = x
    xb = xb.reshape(R, n, _SCAN_BLOCK)
    for i in range(1, _SCAN_BLOCK):
        xb[:, :, i] += xb[:, :, i - 1]
    tot = _cumsum(xb[:, :, -1].contiguous())
    ex = torch.zeros((R, n), dtype=x.dtype, device=x.device)
    ex[:, 1:] = tot[:, :-1]
    return (xb + ex[:, :, None]).reshape(R, n * _SCAN_BLOCK)[:, :N]


def _assign(rows: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    mid = 0.5 * (centers[:, 1:] + centers[:, :-1])
    return (rows[:, :, None] > mid[:, None, :]).sum(-1)


def _seg_mean(svals: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    R, E = svals.shape
    mid = (0.5 * (centers[:, 1:] + centers[:, :-1])).contiguous()
    le = torch.searchsorted(svals.contiguous(), mid, right=True)
    ends = torch.cat([le, le.new_full((R, 1), E)], dim=1)
    starts = torch.cat([le.new_zeros((R, 1)), le], dim=1)
    p = torch.cat([svals.new_zeros((R, 1), dtype=torch.float64),
                   _scan(svals.double())], dim=1)
    num = torch.gather(p, 1, ends) - torch.gather(p, 1, starts)
    den = ends - starts
    return torch.where(den > 0, (num / den.clamp_min(1)).float(), centers)


def _dp_centers(sketch: torch.Tensor, L: int) -> torch.Tensor:
    R, Es = sketch.shape
    dev = sketch.device
    z = torch.zeros((R, 1), dtype=torch.float32, device=dev)
    p1 = torch.cat([z, _cumsum(sketch)], dim=1)
    p2 = torch.cat([z, _cumsum(sketch * sketch)], dim=1)
    i = torch.arange(Es + 1, device=dev)
    n = (i[None, :] - i[:, None]).clamp_min(1).float()
    s1 = p1[:, None, :] - p1[:, :, None]
    s2 = p2[:, None, :] - p2[:, :, None]
    cost = s2 - s1 * s1 / n
    reach = (i[None, :] >= i[:, None])[None]
    cost = torch.where(reach, cost.clamp_min(0.0), _BIG)
    D = cost[:, 0, :]
    Js = []
    for _ in range(L - 1):
        T = D[:, :, None] + cost
        J = torch.argmin(T, dim=1)
        D = torch.gather(T, 1, J[:, None, :])[:, 0]
        Js.append(J)
    rows_ix = torch.arange(R, device=dev)
    b = torch.full((R,), Es, dtype=torch.long, device=dev)
    bounds = [b]
    for k in range(L - 2, -1, -1):
        b = Js[k][rows_ix, b]
        bounds.append(b)
    bounds.append(torch.zeros((R,), dtype=torch.long, device=dev))
    bnd = torch.stack(bounds[::-1], dim=1)
    lo, hi = bnd[:, :-1], bnd[:, 1:]
    cnt = (hi - lo).float()
    seg = torch.gather(p1, 1, hi) - torch.gather(p1, 1, lo)
    mean = seg / cnt.clamp_min(1.0)
    first = torch.where(cnt[:, :1] > 0, mean[:, :1], sketch[:, :1])
    rest = torch.where(cnt[:, 1:] > 0, mean[:, 1:], -_BIG)
    return torch.cummax(torch.cat([first, rest], dim=1), dim=1).values


def freeze_rows(rows: torch.Tensor, num_values: int,
                sketch_mult: int = 4) -> torch.Tensor:
    """rows (R, E) -> their frozen values (R, E) f32: each value replaced
    by its refit center."""
    R, E = rows.shape
    rows = rows.float()
    svals = torch.sort(rows, dim=1).values
    Es = min(E, max(num_values * sketch_mult, 2))
    spos = torch.linspace(0, E - 1, Es, dtype=torch.float64,
                          device=rows.device).round().long()
    centers = _dp_centers(svals[:, spos].contiguous(), num_values)
    idx = _assign(rows, centers)
    centers = _seg_mean(svals, centers)
    return torch.gather(centers, 1, idx)
