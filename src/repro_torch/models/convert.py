"""Converters from the JAX package's state, given as numpy arrays.

``params_from_reference`` takes the reference's parameter pytree
(``jax.tree.map(np.asarray, params)``) and unstacks its scanned ``groups``
axis into the port's per-layer list, so both packages compute the same
function. The paged-cache converter lives beside the cache
(``serving.kv_cache.paged_layer_from_reference``).

A PTQ'd reference tree carries QuantizedTensor leaves (numpy codebook and
indices under ``jax.tree.map``). They cross as the port's QuantizedTensor,
codes unchanged; a stacked leaf (codebook (G, L), indices (G, n)) becomes
layer g's flat ``QuantizedTensor(codebook[g], indices[g])``, its padded
codebook entries kept (no code references them).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import QuantizedTensor


def _t(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16 -> via f32
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))    # a writable copy
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def _torch_dtype(dtype) -> torch.dtype:
    return getattr(torch, np.dtype(dtype).name)


def _tree(tree, device, index=None):
    if isinstance(tree, dict):
        return {k: _tree(v, device, index) for k, v in tree.items()}
    if hasattr(tree, "codebook") and hasattr(tree, "indices"):
        cb, idx = np.asarray(tree.codebook), np.asarray(tree.indices)
        if idx.ndim == 2:                     # stacked: one group's slice
            cb, idx = cb[index], idx[index]
        return QuantizedTensor(_t(cb, device), _t(idx, device),
                               tuple(tree.shape), _torch_dtype(tree.dtype))
    a = np.asarray(tree)
    return _t(a if index is None else a[index], device)


def params_from_reference(tree: dict, cfg, device) -> dict:
    """Reference LM params (numpy leaves) -> the port's params."""
    out = {k: _t(tree[k], device) for k in ("embed", "final_norm",
                                             "lm_head") if k in tree}
    layers = [_tree(tree[f"head_{i}"], device)
              for i in range(len(cfg.head_layers))]
    for g in range(cfg.n_groups):
        for i in range(len(cfg.group)):
            layers.append(_tree(tree["groups"][f"l{i}"], device, index=g))
    out["layers"] = layers
    return out
