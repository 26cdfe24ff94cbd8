"""Kernels of the port (slice 1).

- paged_decode_attention / paged_prefill_attention: fused paged attention
  over the partly frozen KV pool; a hand-written Hopper kernel
  (``csrc/paged_attention.cu``) for CUDA tensors, its plain PyTorch version
  (``ref.ref_paged_decode``) for CPU tensors.
- quantize_pages_device: batched kmeans_ls for KV-page freezing (torch
  code, as in the reference).
"""
from .page_quant import quantize_pages_device, quantize_pages_kmeans_spec
from .paged_attention import (BIG_NEG, modeled_hbm_bytes_per_token,
                              modeled_prefill_hbm_bytes_per_token, pack4,
                              paged_decode_attention, paged_prefill_attention,
                              unpack4)
from .ref import ref_paged_decode

__all__ = [
    "BIG_NEG", "modeled_hbm_bytes_per_token",
    "modeled_prefill_hbm_bytes_per_token", "pack4", "paged_decode_attention",
    "paged_prefill_attention", "quantize_pages_device",
    "quantize_pages_kmeans_spec", "ref_paged_decode", "unpack4",
]
