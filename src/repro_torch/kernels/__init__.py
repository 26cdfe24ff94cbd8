"""Kernels of the port.

- paged_decode_attention / paged_prefill_attention: fused paged attention
  over the partly frozen KV pool; a hand-written Hopper kernel
  (``csrc/paged_attention.cu``) for CUDA tensors, its plain PyTorch version
  (``ref.ref_paged_decode``) for CPU tensors.
- quant_matmul / quant_matmul_stacked: codebook-dequant matrix products
  serving PTQ'd projections from their codes; a hand-written Hopper kernel
  (``csrc/quant_matmul.cu``) for CUDA tensors, the plain versions
  (``ref.ref_quant_matmul[_stacked]``) for CPU tensors.
- fista_quant: batched FISTA on the paper's eq.-6 l1 least squares; a
  hand-written Hopper kernel (``csrc/fista_quant.cu``) for CUDA tensors,
  ``ref.ref_fista`` for CPU tensors. ``ops.solve_fista_batch`` wraps it
  for batched PTQ, ``page_quant.quantize_pages_fista`` for iter_l1 page
  freezing.
- quantize_pages_device: batched kmeans_ls for KV-page freezing (torch
  code, as in the reference).
"""
from .fista_quant import fista_quant
from .ops import power_iter_lipschitz, solve_fista_batch
from .page_quant import (quantize_pages_device, quantize_pages_fista,
                         quantize_pages_kmeans_spec)
from .paged_attention import (BIG_NEG, modeled_hbm_bytes_per_token,
                              modeled_prefill_hbm_bytes_per_token, pack4,
                              paged_decode_attention, paged_prefill_attention,
                              unpack4)
from .quant_matmul import quant_matmul, quant_matmul_stacked
from .ref import (ref_fista, ref_paged_decode, ref_quant_matmul,
                  ref_quant_matmul_stacked)

__all__ = [
    "BIG_NEG", "fista_quant", "modeled_hbm_bytes_per_token",
    "modeled_prefill_hbm_bytes_per_token", "pack4", "paged_decode_attention",
    "paged_prefill_attention", "power_iter_lipschitz", "quant_matmul",
    "quant_matmul_stacked", "quantize_pages_device", "quantize_pages_fista",
    "quantize_pages_kmeans_spec", "ref_fista", "ref_paged_decode",
    "ref_quant_matmul", "ref_quant_matmul_stacked", "solve_fista_batch",
    "unpack4",
]
