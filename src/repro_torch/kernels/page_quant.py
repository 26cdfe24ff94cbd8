"""Batched page quantization for KV-cache freezing (port of
``repro/kernels/page_quant.py``, the kmeans_ls path).

The paper's Algorithm 3 as one batched computation over every
(page, layer, k/v) row of a freeze event:

  - each row is sketched to ``sketch_mult * L`` equal-mass quantiles,
    both extremes included;
  - membership comes from the exact dynamic program for 1-D k-means on
    the sketch (O(1) interval costs from prefix sums), which is globally
    optimal and deterministic;
  - the final assignment (nearest center, i.e. midpoint intervals) and
    the LS refit (per-cluster means, eq. 17-20) run on the full row.

Torch code, not a kernel: the reference runs it as jitted jnp too. The
prefix sums use the reference's CPU summation order (``_cumsum``), so the
DP sees bitwise the same interval costs on every device, and the codes
(which depend only on the DP's centers) agree exactly with the reference.
The refit's per-cluster sums use ``scatter_add_`` (atomics on the card),
so codebooks agree to rounding.
"""
from __future__ import annotations

import torch

_BIG = 1e30
_SCAN_BLOCK = 16


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum along dim 1 in XLA's CPU order: sequential
    inside 16-wide blocks, block totals scanned recursively and added back
    (what ``jnp.cumsum`` computes on the reference's CPU backend)."""
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
    """Interval assignment: cluster id per value given sorted centers."""
    mid = 0.5 * (centers[:, 1:] + centers[:, :-1])           # (N, L-1)
    return (rows[:, :, None] > mid[:, None, :]).sum(-1)


def _seg_mean(rows, idx, centers, L: int) -> torch.Tensor:
    """Per-cluster means (empty clusters keep their previous center)."""
    num = torch.zeros((rows.shape[0], L), dtype=torch.float32,
                      device=rows.device).scatter_add_(1, idx, rows)
    den = torch.zeros_like(num).scatter_add_(1, idx, torch.ones_like(rows))
    return torch.where(den > 0, num / den.clamp_min(1e-20), centers)


def _dp_centers(sketch: torch.Tensor, L: int) -> torch.Tensor:
    """Exact 1-D k-means on sorted rows via a DP over segment boundaries.

    sketch: (R, Es) sorted. Returns (R, L) sorted centers (segment means of
    the optimal L-partition; empty segments inherit the previous center).
    cost[j, i] = sum_{t in [j, i)} (s_t - mean)^2 from prefix sums."""
    R, Es = sketch.shape
    dev = sketch.device
    z = torch.zeros((R, 1), dtype=torch.float32, device=dev)
    p1 = torch.cat([z, _cumsum(sketch)], dim=1)
    p2 = torch.cat([z, _cumsum(sketch * sketch)], dim=1)
    i = torch.arange(Es + 1, device=dev)
    n = (i[None, :] - i[:, None]).clamp_min(1).float()        # (j, i)
    s1 = p1[:, None, :] - p1[:, :, None]                      # (R, j, i)
    s2 = p2[:, None, :] - p2[:, :, None]
    cost = s2 - s1 * s1 / n
    # j <= i are real (j == i is an empty segment at zero cost); j > i is
    # unreachable
    reach = (i[None, :] >= i[:, None])[None]
    cost = torch.where(reach, cost.clamp_min(0.0),
                       torch.tensor(_BIG, device=dev))

    D = cost[:, 0, :]                                         # 1 segment
    Js = []
    for _ in range(L - 1):
        T = D[:, :, None] + cost                              # (R, j, i)
        J = torch.argmin(T, dim=1)                            # first minimum
        D = torch.gather(T, 1, J[:, None, :])[:, 0]
        Js.append(J)

    rows_ix = torch.arange(R, device=dev)
    b = torch.full((R,), Es, dtype=torch.long, device=dev)   # backtrack
    bounds = [b]
    for k in range(L - 2, -1, -1):
        b = Js[k][rows_ix, b]
        bounds.append(b)
    bounds.append(torch.zeros((R,), dtype=torch.long, device=dev))
    bnd = torch.stack(bounds[::-1], dim=1)                    # (R, L+1)
    lo, hi = bnd[:, :-1], bnd[:, 1:]
    cnt = (hi - lo).float()
    seg = torch.gather(p1, 1, hi) - torch.gather(p1, 1, lo)
    mean = seg / cnt.clamp_min(1.0)
    # empty segments: carry the running max so centers stay sorted
    first = torch.where(cnt[:, :1] > 0, mean[:, :1], sketch[:, :1])
    rest = torch.where(cnt[:, 1:] > 0, mean[:, 1:],
                       torch.tensor(-_BIG, device=dev))
    return torch.cummax(torch.cat([first, rest], dim=1), dim=1).values


def _sketch_positions(E: int, Es: int, device) -> torch.Tensor:
    """``round(linspace(0, E-1, Es))`` (round half to even, as jnp)."""
    return torch.linspace(0, E - 1, Es, dtype=torch.float64,
                          device=device).round().long()


def quantize_pages_device(rows: torch.Tensor, *, num_values: int,
                          refit: bool = True, sketch_mult: int = 4):
    """Batched exact-sketch kmeans_ls. rows (R, E) -> (codes (R, E) uint8,
    cb (R, L) f32). Codebooks are sorted ascending and exactly
    ``num_values`` wide; the result does not depend on batch composition."""
    R, E = rows.shape
    L = num_values
    rows = rows.float()
    svals = torch.sort(rows, dim=1).values
    Es = min(E, max(L * sketch_mult, 2))
    spos = _sketch_positions(E, Es, rows.device)
    centers = _dp_centers(svals[:, spos].contiguous(), L)
    idx = _assign(rows, centers)
    if refit:
        # eq. 20 on the full-row membership: per-cluster means are the LS
        # solution for the values (Algorithm 3, step 2)
        centers = _seg_mean(rows, idx, centers, L)
    return idx.to(torch.uint8), centers.float()


def _apply_clip(codes, cb, spec):
    if spec.clip is not None:
        cb = cb.clamp(spec.clip[0], spec.clip[1])
    return codes, cb


def quantize_pages_kmeans_spec(rows, spec):
    """Device entry for ``QuantSpec('kmeans_ls', num_values=L)``."""
    return _apply_clip(*quantize_pages_device(
        rows, num_values=spec.num_values, refit=True), spec)
