"""PyTorch + CUDA port of the ``repro`` serving stack for one NVIDIA H100.

The JAX package ``repro`` is the reference: each module here names the
reference module it ports and is held against it on shared inputs by the
``tests/test_torch_*.py`` suites. This package imports ``torch`` and numpy
only — never ``jax`` and nothing of ``repro``.

Slice 1 serves qwen3-0.6B through continuous batching over a paged KV pool
whose full pages freeze to kmeans_ls codebooks; decode steps and prefill
chunks read the pool through a hand-written Hopper kernel
(``kernels/csrc/paged_attention.cu``).
"""
