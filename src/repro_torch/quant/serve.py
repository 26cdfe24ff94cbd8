"""Quantized serving: value-shared weights feed the dequant matmul kernel
(port of ``repro/quant/serve.py``).

``qmatmul(x, w)`` is ``x @ w`` for a dense ``w``. For a QuantizedTensor it
never materializes the weight: the flat form goes to ``quant_matmul``, and
the stacked form ((G, L) codebooks, (G, n) codes) to
``quant_matmul_stacked`` when ``x`` carries the matching leading group
axis. A stacked weight without that axis means ``x @ W`` with ``x``
broadcast over the groups: on the card ``x`` is copied to every group and
goes through ``quant_matmul_stacked`` too. On the CPU that case is
densified, as the reference does, fp weight traffic the codes were meant
to remove, and bumps ``qmatmul_dequant_fallback``, which the serving
engine reports per run and the launcher requires to be 0 on a PTQ'd run.

The reference counts fallbacks while tracing under jit (once per traced
site); PyTorch runs eagerly, so here the counter counts calls.

``estimate_decode_bytes`` prices a decode step's weight and cache reads
at the H100's HBM rate (``device.HBM_BYTES_PER_S``); the reference's
prices them at v5e's.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import HBM_BYTES_PER_S
from repro_torch.runtime.hints import (gather_data, gather_inner,
                                      gather_inner_grad)
from repro_torch.core.types import QuantizedTensor
from repro_torch.kernels.quant_matmul import quant_matmul, quant_matmul_stacked

_FALLBACKS = {"qmatmul_dequant_fallback": 0}


def fallback_count() -> int:
    """Dense-materialization fallbacks so far in this process
    (monotonic)."""
    return _FALLBACKS["qmatmul_dequant_fallback"]


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """Drop-in for ``x @ w`` taking dense or QuantizedTensor weights. On
    a mesh, a sequence-sharded DTensor ``x`` is gathered first
    (``hints.gather_inner``) and so are ``w``'s data shards
    (``hints.gather_data``, FSDP's all-gather); the output's grad is
    gathered likewise (``hints.gather_inner_grad``)."""
    if not isinstance(w, QuantizedTensor):
        return gather_inner_grad(gather_inner(x) @ gather_data(w))
    K, N = w.shape
    if not w.stacked:
        out = quant_matmul(x.reshape(-1, K).contiguous(),
                           w.indices.reshape(K, N), w.codebook,
                           out_dtype=x.dtype)
        return out.reshape(*x.shape[:-1], N)
    G = w.indices.shape[0]
    idx = w.indices.reshape(G, K, N)
    if x.dim() >= 3 and x.shape[0] == G and x.shape[-1] == K:
        out = quant_matmul_stacked(x.reshape(G, -1, K).contiguous(), idx,
                                   w.codebook, out_dtype=x.dtype)
        return out.reshape(*x.shape[:-1], N)
    if x.device.type == "cpu":
        # no group axis to tile against: materialize the dense stack
        _FALLBACKS["qmatmul_dequant_fallback"] += 1
        return x @ w.to_dense().to(x.dtype)
    return _broadcast_stacked(x, idx, w.codebook)


def _broadcast_stacked(x: torch.Tensor, idx: torch.Tensor,
                       codebook: torch.Tensor) -> torch.Tensor:
    """``x @ W`` for the stacked weight W (G, K, N) = codebook[g][idx[g]],
    with torch.matmul's broadcasting of x's leading axes against G, in one
    ``quant_matmul_stacked`` launch over x copied to every group."""
    G, K, N = idx.shape
    xm = x if x.dim() > 1 else x[None]
    batch = torch.broadcast_shapes(xm.shape[:-2], (G,))
    M, R = xm.shape[-2], math.prod(batch[:-1])
    xg = (xm.expand(*batch, M, K).reshape(R, G, M, K).transpose(0, 1)
          .reshape(G, R * M, K).contiguous())
    out = quant_matmul_stacked(xg, idx, codebook, out_dtype=x.dtype)
    out = out.reshape(G, R, M, N).transpose(0, 1).reshape(*batch, M, N)
    return out if x.dim() > 1 else out.squeeze(-2)


def estimate_decode_bytes(params_bytes_dense: int, ratio: float,
                          cache_bytes: int, *,
                          hbm_bytes_per_s: float = HBM_BYTES_PER_S) -> dict:
    """Decode is memory-bound: a step's time is about (weights + cache)
    bytes over the HBM rate, with the weights ``ratio`` times smaller
    when quantized. Returns ``t_dense_s``, ``t_quant_s`` and
    ``speedup``."""
    dense = (params_bytes_dense + cache_bytes) / hbm_bytes_per_s
    quant = (params_bytes_dense / ratio + cache_bytes) / hbm_bytes_per_s
    return {"t_dense_s": dense, "t_quant_s": quant, "speedup": dense / quant}
