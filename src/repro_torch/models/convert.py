"""Converters from the JAX package's state, given as numpy arrays.

``params_from_reference`` takes the reference's parameter pytree
(``jax.tree.map(np.asarray, params)``) and unstacks its scanned ``groups``
axis into the port's per-layer list, so both packages compute the same
function. Every leaf crosses by name, gemma2's ``post_ln1``/``post_ln2``
and an untied ``lm_head`` among them, and so do the families' own: MoE's
``router``, expert stacks ``w_gate``/``w_up``/``w_down`` (E, D, F) and
``shared`` FFN, MLA's ``wq``/``wdkv``/``wkr``/``wukv``/``wo``, the
cross-attention ``c_*`` projections, the encoder's stacked
``enc_groups`` (unstacked into ``enc_layers``) and ``enc_norm``, and the
state-space mixers' leaves (Mamba's ``w_in``, ``conv_w``, ``w_bcdt``,
``w_dt``, ``dt_bias``, ``A_log``, ``D_skip``, ``w_out``; RWKV-6's time
and channel mix, ``w0`` and ``u`` among them), each in its own dtype (f32
``A_log``, ``D_skip``, ``w0`` and ``u`` in a bf16 model). jamba's
heterogeneous 8-layer group unstacks like any other: layer i of group g
is list entry ``8 g + i``. The paged-cache converter lives beside the cache
(``serving.kv_cache.paged_layer_from_reference``).

``opt_state_from_reference`` takes an optimizer state (AdamW's ``m``,
``v``, ``count``; Adafactor's ``v`` of ``vr``/``vc`` or ``v``, ``m``,
``count``) as it is: the port keeps that state in the reference's stacked
layout (``optim``). ``mlp_params_from_reference`` takes the paper's MLP
(a list of {"w", "b"}).

A PTQ'd reference tree carries QuantizedTensor leaves (numpy codebook and
indices under ``jax.tree.map``). They cross as the port's QuantizedTensor,
codes unchanged; a stacked leaf (codebook (G, L), indices (G, n)) becomes
layer g's flat ``QuantizedTensor(codebook[g], indices[g])``, its padded
codebook entries kept (no code references them). An expert stack's
stacked leaf is quantized per group as one (E, D, F) tensor
(``quant/ptq.py``), so layer g's slice is one flat QuantizedTensor of
shape (E, D, F).
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


def _unstack(groups: dict, n_groups: int, group_len: int, device) -> list:
    return [_tree(groups[f"l{i}"], device, index=g)
            for g in range(n_groups) for i in range(group_len)]


def params_from_reference(tree: dict, cfg, device) -> dict:
    """Reference params (numpy leaves; LM or encdec) -> the port's."""
    out = {k: _tree(tree[k], device) for k in ("embed", "final_norm",
                                                "lm_head", "enc_norm")
           if k in tree}
    out["layers"] = [_tree(tree[f"head_{i}"], device)
                     for i in range(len(cfg.head_layers))] + _unstack(
        tree["groups"], cfg.n_groups, len(cfg.group), device)
    if "enc_groups" in tree:          # the encoder: one layer a group
        out["enc_layers"] = _unstack(tree["enc_groups"], cfg.n_enc_layers,
                                     1, device)
    return out


def opt_state_from_reference(tree: dict, device) -> dict:
    """Reference optimizer state (numpy leaves) -> the port's, leaf for
    leaf in the reference's stacked layout."""
    return _tree(tree, device)


def mlp_params_from_reference(layers, device) -> list:
    return [_tree(layer, device) for layer in layers]
