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
it checks attributes, looks up the cached launch ``plan``, allocates the
output and makes one ctypes call (one kernel launch).

``plan(K, N, L, x_dtype, idx_dtype)`` chooses the kernel's split of K over
a thread-block cluster from the weight's shape and the dtypes alone: never
from M or G, so a row's result does not depend on how many rows or groups
share its call. The kernel lays out its own shared memory
(``kernel_smem``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build
from .ref import ref_quant_matmul, ref_quant_matmul_stacked

__all__ = ["QmmPlan", "kernel_smem", "plan", "quant_matmul",
           "quant_matmul_stacked"]

# the kernel's constants (csrc/quant_matmul.cu)
L_MAX = 32768           # codebook entries the kernel stages
BM, BN, BK = 64, 64, 64  # output rows and columns of a block; depth of a step
MAX_SPLITS = 8          # the portable cluster size
# 128-192 blocks a projection at G = 1 (132 SMs): fewer splits lost to the
# blocks' residency on the H100 (tools/qmm_probe.py --sweep, PERF.md)
TARGET_BLOCKS = 176
_X_DTYPES = (torch.float32, torch.bfloat16)
_IDX_DTYPES = (torch.uint8, torch.int32)


class QmmPlan(NamedTuple):
    """How the kernel cuts one (K, N) weight: ``splits`` K ranges of
    ``split_steps`` whole BK steps (the last may be shorter), the splits of
    a column tile one cluster of (splits, 1, 1) blocks."""
    bn: int
    bk: int
    splits: int
    split_steps: int
    col_tiles: int

    @property
    def cluster(self) -> tuple[int, int, int]:
        return (self.splits, 1, 1)

    @property
    def blocks_per_row_tile(self) -> int:
        """Blocks a (BM-row tile, group) launches: every row tile and every
        group adds as many."""
        return self.col_tiles * self.splits

    def k_ranges(self, K: int) -> list[tuple[int, int]]:
        """Each split's [k0, k1): whole BK steps, K ends the last."""
        step = self.split_steps * self.bk
        return [(s * step, min((s + 1) * step, K))
                for s in range(self.splits)]


@functools.cache
def plan(K: int, N: int, L: int, x_dtype: torch.dtype,
         idx_dtype: torch.dtype) -> QmmPlan:
    """The launch plan of a (K, N) weight with L codebook entries: enough
    splits of K (at most MAX_SPLITS) that the column tiles times the splits
    reach TARGET_BLOCKS, every split whole BK steps. L and the dtypes size
    only the kernel's shared memory, which fits at every split (at most
    211 KB of 227 KB, at L = L_MAX with f32 x and int32 codes)."""
    steps = -(-K // BK)
    col_tiles = -(-N // BN)
    want = min(MAX_SPLITS, steps, -(-TARGET_BLOCKS // col_tiles))
    split_steps = -(-steps // want)
    splits = -(-steps // split_steps)
    return QmmPlan(BN, BK, splits, split_steps, col_tiles)


@functools.cache
def _kernel():
    fn = build.load("quant_matmul").quant_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_smem(pl: QmmPlan, L: int, x_dtype: torch.dtype,
                idx_dtype: torch.dtype) -> tuple[int, int]:
    """(ring slots, shared-memory bytes) of a block of the kernel under
    plan ``pl``, as the kernel lays them out (builds the kernel)."""
    fn = build.load("quant_matmul").quant_matmul_smem
    stages = ctypes.c_int()
    smem = fn(L, int(x_dtype == torch.bfloat16),
              int(idx_dtype == torch.int32), pl.split_steps,
              ctypes.byref(stages))
    if smem < 0:
        raise ValueError(f"kernel_smem: no layout for L={L}, {pl}")
    return stages.value, smem


def _launch(wrapper, x, idx, codebook, out_dtype, pl=None):
    """x (G, M, K), idx (G, K, N), codebook (G, L), all on one CUDA
    device -> (G, M, N) in x's dtype; counts the launch on ``wrapper``.
    ``pl`` replaces the weight's own plan (tools/qmm_probe.py --sweep)."""
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
    pl = pl or plan(K, N, L, x.dtype, idx.dtype)
    rc = _kernel()(x.data_ptr(), idx.data_ptr(), codebook.data_ptr(),
                   out.data_ptr(), G, M, K, N, L,
                   int(x.dtype == torch.bfloat16),
                   int(idx.dtype == torch.int32), pl.splits, pl.split_steps,
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
