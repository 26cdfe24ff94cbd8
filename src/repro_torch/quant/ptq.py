"""Post-training quantization of a whole parameter tree (port of
``repro/quant/ptq.py``).

``quantize_tree(params, spec)`` quantizes every eligible leaf with
``core.quantize`` on the leaf's device and returns (qtree, report): a tree
mirroring ``params`` with QuantizedTensor leaves, and one report row per
quantized leaf. The port keeps its layers as a list (``layers/<i>/...``),
so each layer's 2-D projection is quantized on its own, which equals the
reference's per-group slices of a stacked ``groups`` leaf.

``batched=True`` (lam methods registered ``tree_batched``: l1_ls) solves
the whole tree in one FISTA kernel launch (``kernels.ops``). The
reference solves each stacked ``groups`` leaf as ONE vector, so all
layers share one codebook per projection; to compute the same thing the
port groups the per-layer leaves of one projection name
(``layers/*/mixer/wq``) into one problem, and each layer's leaf serves its
own codes against the shared codebook. The reference's deprecated
loose-kwargs forms are not ported.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.core import (QuantizedTensor, QuantSpec, from_dense,
                              make_problem, quantize, refit_support,
                              registry, support_of, unique_with_counts)
from repro_torch.kernels.ops import solve_fista_batch

DEFAULT_SKIP = ("ln", "norm", "router", "A_log", "mix", "dt_bias", "D_skip",
                "w0")


def should_quantize(name: str, leaf: torch.Tensor, skip_patterns) -> bool:
    """A leaf of 2 or more dims whose path ``name`` matches no pattern."""
    if leaf.dim() < 2:
        return False
    return not any(re.search(p, name) for p in skip_patterns)


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
    return fn("/".join(path), tree)


def quantize_tree(params, spec: QuantSpec | str, *,
                  skip_patterns=DEFAULT_SKIP, batched: bool = False,
                  **solver_kw):
    """Quantize every eligible leaf. Returns (qtree, report); report rows
    carry n_values, bytes, dense_bytes and the spec (and l2_loss per
    leaf, or the shared problem's ``group`` when batched). ``batched=True``
    solves every leaf in one FISTA launch (a ``tree_batched`` lam spec;
    ``solver_kw``: n_iters, max_unique)."""
    spec = QuantSpec.parse(spec)
    if batched:
        if not registry.get(spec.method).tree_batched:
            raise ValueError(
                f"batched=True needs a tree-batched lam method (registry: "
                f"{', '.join(n for n in registry.methods() if registry.get(n).tree_batched)}"
                f"), got {str(spec)!r}")
        return _quantize_tree_batched(params, spec,
                                      skip_patterns=skip_patterns,
                                      **solver_kw)
    report = {}

    def per_leaf(name, leaf):
        if not isinstance(leaf, torch.Tensor) or not should_quantize(
                name, leaf, skip_patterns):
            return leaf
        qt, info = quantize(leaf, spec, **solver_kw)
        report[name] = {
            "n_values": info["n_values"], "l2_loss": info["l2_loss"],
            "bytes": qt.nbytes(),
            "dense_bytes": leaf.numel() * leaf.element_size(),
            "spec": str(spec),
        }
        return qt

    return _map(params, per_leaf), report


def _group_key(name: str) -> str:
    """The problem a leaf belongs to when batched: the per-layer leaves of
    one projection (``layers/<i>/x`` -> ``layers/*/x``) form one, as the
    reference's stacked leaf does."""
    parts = name.split("/")
    if len(parts) > 2 and parts[0] == "layers" and parts[1].isdigit():
        parts[1] = "*"
    return "/".join(parts)


def _quantile_linear(vals: torch.Tensor, q: np.ndarray) -> torch.Tensor:
    """``np.quantile(vals, q)`` (method "linear") of sorted float64
    ``vals``, on their device: numpy's virtual index and its two-sided
    lerp, so the bucket edges are numpy's bit for bit."""
    m = vals.numel()
    vi = torch.from_numpy(m * q + (1.0 + q * (1.0 - 1.0 - 1.0)) - 1.0).to(
        vals.device)
    lo = torch.floor(vi)
    g = vi - lo
    i = lo.long().clamp(0, m - 1)
    a, b = vals[i], vals[(i + 1).clamp(max=m - 1)]
    diff = b - a
    return torch.where(g >= 0.5, b - diff * (1.0 - g), a + diff * g)


def _bucket(vals, counts, inv, max_unique: int):
    """Cap a problem at ``max_unique`` unique values as the reference does:
    values cut at ``max_unique`` quantiles, each bucket replaced by its
    count-weighted mean. Bucket sums are float64 prefix-sum differences
    (buckets are contiguous runs of the sorted values), deterministic on
    the card."""
    edges = _quantile_linear(vals, np.linspace(0, 1, max_unique + 1)[1:-1])
    bucket = torch.searchsorted(edges, vals)
    ids = torch.arange(max_unique, device=vals.device)
    start = torch.searchsorted(bucket, ids)
    end = torch.searchsorted(bucket, ids, right=True)
    zero = vals.new_zeros(1)
    cn = torch.cat([zero, torch.cumsum(counts, 0)])
    cv = torch.cat([zero, torch.cumsum(counts * vals, 0)])
    bcnt = cn[end] - cn[start]
    bsum = cv[end] - cv[start]
    nz = bcnt > 0
    remap = torch.cumsum(nz.long(), 0) - 1
    return bsum[nz] / bcnt[nz], bcnt[nz], remap[bucket[inv]]


def tree_problems(params, spec: QuantSpec, *, max_unique: int = 4096,
                  skip_patterns=DEFAULT_SKIP):
    """The problems of a batched PTQ: one per group of leaves
    (``_group_key``), each its leaves' sorted unique values (bucketed to
    ``max_unique``), counts and inverse index, and the padded rows the
    FISTA solve takes. Returns (probs, W, D, N): probs a list of
    (key, [(name, leaf)], vals, counts, inverse); W, D, N (B, M) f32."""
    groups: dict[str, list] = {}

    def collect(name, leaf):
        if isinstance(leaf, torch.Tensor) and should_quantize(
                name, leaf, skip_patterns):
            groups.setdefault(_group_key(name), []).append((name, leaf))
        return leaf

    _map(params, collect)
    probs = []
    for key, members in groups.items():
        vals, counts, inv = unique_with_counts(
            torch.cat([leaf.reshape(-1) for _, leaf in members]))
        if vals.numel() > max_unique:    # ultra-high-cardinality tensors
            vals, counts, inv = _bucket(vals, counts, inv, max_unique)
        probs.append((key, members, vals, counts, inv))
    dev = probs[0][2].device if probs else "cpu"
    B, M = len(probs), max((p[2].numel() for p in probs), default=0)
    W = torch.zeros((B, M), dtype=torch.float32, device=dev)
    D, N = torch.zeros_like(W), torch.zeros_like(W)
    for i, (_, _, vals, counts, _) in enumerate(probs):
        m = vals.numel()
        W[i, :m] = vals.float()
        D[i, :m] = torch.diff(vals, prepend=vals.new_zeros(1)).float()
        N[i, :m] = counts.float() if spec.weighted else 1.0
    return probs, W, D, N


def _quantize_tree_batched(params, spec: QuantSpec, *, n_iters: int = 1000,
                           max_unique: int = 4096,
                           skip_patterns=DEFAULT_SKIP):
    """One FISTA launch for every problem of the tree (each padded to the
    longest), then each problem's LS refit on its l1 support (l1_ls's
    contract, solved by FISTA). A problem's leaves share its codebook."""
    probs, W, D, N = tree_problems(params, spec, max_unique=max_unique,
                                   skip_patterns=skip_patterns)
    if not probs:
        return params, {}
    alpha = solve_fista_batch(W, D, N, spec.lam, n_iters=n_iters)

    qts, report = {}, {}
    for i, (key, members, vals, counts, inv) in enumerate(probs):
        m = vals.numel()
        prob = make_problem(vals, counts, weighted=spec.weighted)
        recon, _ = refit_support(prob, support_of(alpha[i, :m]))
        if spec.clip is not None:
            recon = recon.clamp(spec.clip[0], spec.clip[1])
        off = 0
        for name, leaf in members:
            qt = from_dense(leaf, recon, inv[off:off + leaf.numel()])
            off += leaf.numel()
            qts[name] = qt
            report[name] = {
                "n_values": qt.num_values, "bytes": qt.nbytes(),
                "dense_bytes": leaf.numel() * leaf.element_size(),
                "spec": str(spec), "group": key}
    return _map(params, lambda name, leaf: qts.get(name, leaf)), report


def dequantize_tree(qtree):
    return _map(qtree, lambda _, leaf: leaf.to_dense()
                if isinstance(leaf, QuantizedTensor) else leaf)


def compression_ratio(report) -> float:
    dense = sum(r.get("dense_bytes", 0) for r in report.values())
    comp = sum(r["bytes"] for r in report.values())
    return dense / max(comp, 1)
