"""Optimal 1-D k-segment quantizer by divide-and-conquer DP (port of
``repro/core/dp_optimal.py``; beyond the paper).

Ckmeans.1d.dp-style: D[k][j] = min_i D[k-1][i-1] + cost(i, j), the cost
being the weighted within-segment squared error, O(1) from prefix sums.
The argmin is monotone in j, so each layer solves in O(m log m) by divide
and conquer. Its SSE is the information-loss lower bound of any l-value
scalar quantizer, which scores every other method.

A host solve: numpy's float64 prefix sums (the reference's), then the
DP over Python floats (IEEE doubles, the same operations as numpy's
float64 scalars) in the reference's divide-and-conquer order with its
strict ``<`` ties, so recon, assignment, centers and sse are bitwise the
reference's. Returns tensors on the values' device.
"""
from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64)


def optimal_kmeans_1d(vals, counts, k: int):
    """Returns (recon (m,) f64, assignment (m,) int64, centers (k',) f64,
    sse) with k' <= k, on ``vals``' device (the CPU for numpy input).
    ``vals`` sorted ascending, ``counts`` their weights."""
    dev = vals.device if isinstance(vals, torch.Tensor) else "cpu"
    y, n = _host(vals), _host(counts)
    m = y.shape[0]
    k = min(k, m)
    # prefix sums for the O(1) weighted cost of a segment [i, j]
    cn = np.concatenate([[0.0], np.cumsum(n)]).tolist()
    cy = np.concatenate([[0.0], np.cumsum(n * y)]).tolist()
    cy2 = np.concatenate([[0.0], np.cumsum(n * y * y)]).tolist()

    def cost(i: int, j: int) -> float:   # segment [i, j], inclusive
        sn = cn[j + 1] - cn[i]
        if sn <= 0:
            return 0.0
        sy = cy[j + 1] - cy[i]
        return (cy2[j + 1] - cy2[i]) - sy * sy / sn

    INF = float("inf")
    prev = [cost(0, j) for j in range(m)]
    back = np.zeros((k, m), dtype=np.int64)

    for layer in range(1, k):
        cur = [INF] * m
        row = back[layer]

        def solve(jlo: int, jhi: int, ilo: int, ihi: int) -> None:
            if jlo > jhi:
                return
            jmid = (jlo + jhi) // 2
            best, arg = INF, ilo
            # i >= layer, so that layers 0..layer-1 each hold >= 1 point
            for i in range(max(ilo, layer), min(ihi, jmid) + 1):
                c = prev[i - 1] + cost(i, jmid)
                if c < best:
                    best, arg = c, i
            cur[jmid] = best
            row[jmid] = arg
            solve(jlo, jmid - 1, ilo, arg)
            solve(jmid + 1, jhi, arg, ihi)

        solve(layer, m - 1, layer, m - 1)
        prev = cur

    # k segments (fewer distinct values can never be better)
    sse = prev[m - 1] if k > 1 else cost(0, m - 1)
    bounds: list[int] = []
    j = m - 1
    for layer in range(k - 1, 0, -1):
        i = int(back[layer, j])
        bounds.append(i)
        j = i - 1
    starts = [0] + sorted(bounds)
    ends = starts[1:] + [m]
    assignment = np.zeros(m, dtype=np.int64)
    centers = np.empty(len(starts))
    for s_idx, (s, e) in enumerate(zip(starts, ends)):
        assignment[s:] = s_idx
        centers[s_idx] = (cy[e] - cy[s]) / max(cn[e] - cn[s], 1e-300)
    recon = centers[assignment]
    t = lambda a: torch.from_numpy(a).to(dev)
    return t(recon), t(assignment), t(centers), float(sse)
