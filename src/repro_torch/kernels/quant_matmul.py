"""Codebook-dequant matrix products (port of
``repro/kernels/quant_matmul.py`` and its shape-flexible wrappers in
``repro/kernels/ops.py``).

``quant_matmul(x, idx, codebook)`` is ``x @ codebook[idx]`` with the
weight never materialized: for CUDA tensors it launches the hand-written
Hopper kernel ``csrc/quant_matmul.cu``; for CPU tensors it runs the plain
version, ``ref.ref_quant_matmul``. ``quant_matmul_stacked`` is the same
with a leading group axis (per-group codebooks). On a CUDA tensor there is
no fallback: what the kernel does not take raises. Each wrapper counts its
kernel launches in ``.launches`` (never plain-version calls).

Any M, K, N: the kernel masks ragged edges itself. A decode step calls
this once per projection and layer (7 x 28 on qwen3-0.6B), so the CUDA
path does no host sync, no padding copy and no host-side shape tensor:
it checks attributes, allocates the output and makes one ctypes call.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import ref_quant_matmul, ref_quant_matmul_stacked

__all__ = ["quant_matmul", "quant_matmul_stacked"]

L_MAX = 32768           # codebook entries the kernel stages (csrc L_MAX)
_X_DTYPES = (torch.float32, torch.bfloat16)
_IDX_DTYPES = (torch.uint8, torch.int32)


@functools.cache
def _kernel():
    fn = build.load("quant_matmul").quant_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(wrapper, x, idx, codebook, out_dtype):
    """x (G, M, K), idx (G, K, N), codebook (G, L), all on one CUDA
    device -> (G, M, N) in x's dtype; counts the launch on ``wrapper``."""
    name = wrapper.__name__
    G, M, K = x.shape
    N = idx.shape[2]
    L = codebook.shape[1]
    dev = x.device
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"{name}: x dtype {x.dtype} (want f32 or bf16)")
    if idx.dtype not in _IDX_DTYPES:
        raise ValueError(f"{name}: codes dtype {idx.dtype} (want uint8 or "
                         f"int32)")
    if codebook.dtype != torch.float32:
        raise ValueError(f"{name}: codebook dtype {codebook.dtype} (want "
                         f"f32)")
    if out_dtype is not None and out_dtype != x.dtype:
        raise ValueError(f"{name}: the kernel writes x's dtype {x.dtype}, "
                         f"not {out_dtype}")
    if idx.shape[:2] != (G, K) or codebook.shape[0] != G:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, codes "
                         f"{tuple(idx.shape)}, codebook "
                         f"{tuple(codebook.shape)} do not match")
    if not 0 < L <= L_MAX:
        raise ValueError(f"{name}: codebook of {L} entries (the kernel "
                         f"stages at most {L_MAX})")
    if idx.device != dev or codebook.device != dev:
        raise ValueError(f"{name}: tensors on {idx.device}/"
                         f"{codebook.device}, x on {dev}")
    if not (x.is_contiguous() and idx.is_contiguous()
            and codebook.is_contiguous()):
        raise ValueError(f"{name}: every tensor must be contiguous")
    out = torch.empty((G, M, N), dtype=x.dtype, device=dev)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    rc = _kernel()(x.data_ptr(), idx.data_ptr(), codebook.data_ptr(),
                   out.data_ptr(), G, M, K, N, L,
                   int(x.dtype == torch.bfloat16),
                   int(idx.dtype == torch.int32),
                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    wrapper.launches += 1
    return out


def _check_device(name, x):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device.type} tensors")


def quant_matmul(x: torch.Tensor, idx: torch.Tensor, codebook: torch.Tensor,
                 *, out_dtype=None) -> torch.Tensor:
    """y = x @ codebook[idx]: x (M, K) bf16/f32, idx (K, N) uint8/int32
    codes, codebook (L,) f32 -> (M, N) in x's dtype (``out_dtype`` only on
    the CPU), accumulated in f32 with the gathered weight rounded to x's
    dtype first."""
    if x.device.type == "cpu":
        return ref_quant_matmul(x, idx, codebook, out_dtype)
    _check_device("quant_matmul", x)
    if x.dim() != 2 or idx.dim() != 2 or codebook.dim() != 1:
        raise ValueError("quant_matmul: x (M, K), idx (K, N), codebook (L,)")
    return _launch(quant_matmul, x[None], idx[None], codebook[None],
                   out_dtype)[0]


quant_matmul.launches = 0


def quant_matmul_stacked(x: torch.Tensor, idx: torch.Tensor,
                         codebook: torch.Tensor, *,
                         out_dtype=None) -> torch.Tensor:
    """y[g] = x[g] @ codebook[g][idx[g]]: x (G, M, K), idx (G, K, N),
    codebook (G, L) -> (G, M, N); one launch for every group."""
    if x.device.type == "cpu":
        return ref_quant_matmul_stacked(x, idx, codebook, out_dtype)
    _check_device("quant_matmul_stacked", x)
    if x.dim() != 3 or idx.dim() != 3 or codebook.dim() != 2:
        raise ValueError("quant_matmul_stacked: x (G, M, K), idx (G, K, N), "
                         "codebook (G, L)")
    return _launch(quant_matmul_stacked, x, idx, codebook, out_dtype)


quant_matmul_stacked.launches = 0
