"""Batched page quantization for KV-cache freezing (port of
``repro/kernels/page_quant.py``).

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
The refit's per-cluster sums are differences of a float64 prefix sum over
the sorted row (no atomics), so codebooks agree to rounding and do not
change from run to run.

``quantize_pages_fista`` is the lam-method backend (registered for
``iter_l1``): every row is sketched the same way, solved for the paper's
eq. 6 by FISTA under a per-row lambda found by bisection so that the
support fits the count budget (``fista_freeze``: one kernel launch on the
card for the whole solve), then assigned and LS-refit on the full row as
on the kmeans path. All of it stays on the device with no host sync, so a
freeze is one asynchronous dispatch on the side stream. Every reduction
over a row runs in a fixed order made of elementwise ops (``ref.scan``,
``ref.fsum``, prefix-sum differences for the refit), so a row's codes and
codebook are bitwise the same whatever the number of rows in the call.
(``torch.cumsum`` and ``torch.sum`` promise no such thing on the card:
their kernels may change with the number of rows.)

The ``*_spec`` functions at the bottom are the registry's device entries,
``(rows, spec) -> (codes, cb)``.
"""
from __future__ import annotations

import torch

from .fista_quant import (CHUNK, fista_freeze, freeze_problem, nnz_of,
                          start_vector)
from .ref import fsum, scan

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


def _seg_mean(svals: torch.Tensor, centers: torch.Tensor,
                     L: int) -> torch.Tensor:
    """Per-cluster means of the interval assignment to sorted ``centers``
    (empty clusters keep their center), from the sorted rows: the
    clusters are contiguous runs of ``svals``, so their sums are
    differences of one float64 prefix sum in a fixed order and their
    counts come from ``searchsorted``. Empty clusters keep their center."""
    R, E = svals.shape
    mid = (0.5 * (centers[:, 1:] + centers[:, :-1])).contiguous()
    le = torch.searchsorted(svals.contiguous(), mid, right=True)  # #(<= mid)
    ends = torch.cat([le, le.new_full((R, 1), E)], dim=1)         # (R, L)
    starts = torch.cat([le.new_zeros((R, 1)), le], dim=1)
    p = torch.cat([svals.new_zeros((R, 1), dtype=torch.float64),
                   scan(svals.double())], dim=1)
    num = torch.gather(p, 1, ends) - torch.gather(p, 1, starts)
    den = ends - starts
    return torch.where(den > 0, (num / den.clamp_min(1)).float(), centers)


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
    cost = torch.where(reach, cost.clamp_min(0.0), _BIG)

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
    rest = torch.where(cnt[:, 1:] > 0, mean[:, 1:], -_BIG)
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
        centers = _seg_mean(svals, centers, L)
    return idx.to(torch.uint8), centers.float()


# ---------------------------------------------------------------- FISTA path

_T = CHUNK              # sketch width: one 128-column block (a warp's)


def fista_page_sketch(rows: torch.Tensor) -> dict:
    """Each row sketched to ``Es = min(E, 128)`` equal-mass quantiles, both
    extremes included (one lane block: a 2-block sketch measured worse in
    the reference), each of weight E / Es. Returns the sorted rows
    ``svals``, the sketch ``s`` and the padded w, d, n (R, 128) of the
    eq.-6 problem on it."""
    R, E = rows.shape
    dev = rows.device
    svals = torch.sort(rows, dim=1).values
    Es = min(E, _T)
    s = svals[:, _sketch_positions(E, Es, dev)]                # (R, Es)
    pad = (0, _T - Es)
    F = torch.nn.functional
    return dict(
        svals=svals, s=s, w=F.pad(s, pad),
        d=F.pad(torch.diff(s, dim=1, prepend=s.new_zeros(R, 1)), pad),
        n=F.pad(torch.full((R, Es), E / Es, dtype=torch.float32, device=dev),
                pad))


def fista_page_problem(rows: torch.Tensor) -> dict:
    """The sketched eq.-6 problem of each row, preconditioned, with its
    step size: ``fista_page_sketch``'s entries and ``freeze_problem``'s
    (``dt``, ``scale``, ``eta`` (R, 1, 1), ``lam_hi`` (R,)), what the
    bisection hands the kernel."""
    sk = fista_page_sketch(rows.float())
    return dict(sk, **freeze_problem(sk["w"], sk["d"], sk["n"],
                                     start_vector(_T, rows.device)))


def fista_page_refit(rows: torch.Tensor, sk: dict, best: torch.Tensor,
                     L: int):
    """Codes and codebook from the solved support ``best`` (R, 128) of the
    sketch ``sk``: the support's levels on the sketch (the pre-support
    zero run is its own level) give count-weighted means, sorted (empty
    levels inherit their left neighbour, so codebooks are exactly L
    wide); the codes are the full row's interval assignment to them, and
    the codebook its per-cluster means (eq. 20)."""
    n = sk["n"]
    _, sup = nnz_of(best)
    sid = torch.cumsum(sup.long(), dim=1)
    lid = torch.clamp(sid - sup[:, :1].long(), 0, L - 1)
    # one-hot by comparison: F.one_hot checks its ids on the host, a sync
    levels = torch.arange(L, device=rows.device)
    ohn = (lid[:, :, None] == levels).float() * n[:, :, None]
    num = fsum(sk["w"][:, :, None] * ohn)
    den = fsum(ohn)
    mean = torch.where(den > 0, num / den.clamp_min(1e-20),
                       torch.full_like(num, -_BIG))
    # levels are contiguous runs of sorted values: nonempty means ascend
    first = torch.where(den[:, :1] > 0, mean[:, :1], sk["s"][:, :1])
    centers = torch.cummax(torch.cat([first, mean[:, 1:]], dim=1),
                           dim=1).values
    idx = _assign(rows, centers)
    centers = _seg_mean(sk["svals"], centers, L)
    return idx.to(torch.uint8), centers


def quantize_pages_fista(rows: torch.Tensor, *, num_values: int):
    """Batched lam-method page solver: sketch -> per-row lambda bisection
    by FISTA (``fista_freeze``) -> full-row assignment + LS refit.

    rows (R, E) -> (codes (R, E) uint8, cb (R, L) f32), the contract of
    ``quantize_pages_device``. The bisection (``fista_quant.BISECT_STEPS``
    steps of ``FISTA_ITERS`` FISTA steps) keeps, per row, the smallest
    lambda whose l1 support fits ``num_values`` levels;
    ``fista_page_refit`` turns that support into codes and codebook. The
    reference's optional Lloyd rounds (``lloyd_rounds``, off by default
    there) and its ``n_iters``/``bisect_steps`` arguments (only their
    defaults are used) are not ported."""
    rows = rows.float()
    sk = fista_page_sketch(rows)
    best = fista_freeze(sk["w"], sk["d"], sk["n"],
                        start_vector(_T, rows.device),
                        num_values=num_values)[0]
    return fista_page_refit(rows, sk, best, num_values)


def _apply_clip(codes, cb, spec):
    if spec.clip is not None:
        cb = cb.clamp(spec.clip[0], spec.clip[1])
    return codes, cb


def quantize_pages_kmeans_spec(rows, spec):
    """Device entry for ``QuantSpec('kmeans_ls', num_values=L)``."""
    return _apply_clip(*quantize_pages_device(
        rows, num_values=spec.num_values, refit=True), spec)


def quantize_pages_kmeans_raw_spec(rows, spec):
    """Device entry for ``QuantSpec('kmeans', num_values=L)``: the DP's
    centers, no refit."""
    return _apply_clip(*quantize_pages_device(
        rows, num_values=spec.num_values, refit=False), spec)


def quantize_pages_fista_spec(rows, spec):
    """Device entry for ``QuantSpec('iter_l1', num_values=L)``."""
    return _apply_clip(*quantize_pages_fista(
        rows, num_values=spec.num_values), spec)
