"""Quantization-aware training (port of ``repro/quant/qat.py``):
straight-through fake-quant with the paper's quantizers providing the
codebooks."""
from __future__ import annotations

import torch

from repro_torch.tree import items, unflatten


def fake_quant(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Snap x to its nearest codebook value (ties to the lower, as the
    reference's left ``searchsorted`` over the midpoints); identity
    gradient (straight-through)."""
    cb = torch.sort(codebook).values
    mid = 0.5 * (cb[1:] + cb[:-1])
    snapped = cb[torch.searchsorted(mid, x.contiguous())]
    return x + (snapped - x).detach()


def qat_params(params, codebooks: dict):
    """Fake-quant every leaf whose ``/``-joined path (``layers/3/ffn/
    w_up``; list entries by index) has a codebook."""
    return unflatten(params, [
        leaf if codebooks.get(key) is None else fake_quant(leaf,
                                                           codebooks[key])
        for key, leaf in items(params)])
