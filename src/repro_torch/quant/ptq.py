"""Post-training quantization of a whole parameter tree (port of
``repro/quant/ptq.py``, the per-leaf host path).

``quantize_tree(params, spec)`` quantizes every eligible leaf with
``core.quantize`` on the leaf's device and returns (qtree, report): a tree
mirroring ``params`` with QuantizedTensor leaves, and one report row per
quantized leaf. The port keeps its layers as a list (``layers/<i>/...``),
so each layer's 2-D projection is quantized on its own, which equals the
reference's per-group slices of a stacked ``groups`` leaf. The
reference's ``batched=True`` path (one FISTA kernel launch for the whole
tree) is not ported yet, nor its deprecated loose-kwargs forms.
"""
from __future__ import annotations

import re

import torch

from repro_torch.core import QuantizedTensor, QuantSpec, quantize

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
                  skip_patterns=DEFAULT_SKIP, **solver_kw):
    """Quantize every eligible leaf. Returns (qtree, report); report rows
    carry n_values, l2_loss, bytes, dense_bytes and the spec."""
    spec = QuantSpec.parse(spec)
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


def dequantize_tree(qtree):
    return _map(qtree, lambda _, leaf: leaf.to_dense()
                if isinstance(leaf, QuantizedTensor) else leaf)


def compression_ratio(report) -> float:
    dense = sum(r.get("dense_bytes", 0) for r in report.values())
    comp = sum(r["bytes"] for r in report.values())
    return dense / max(comp, 1)
