"""Fused paged attention over the paged, partly frozen KV pool (port of
``repro/kernels/paged_attention.py``).

``paged_decode_attention`` launches the hand-written Hopper kernel
``csrc/paged_attention.cu`` for CUDA tensors; for CPU tensors it runs the
kernel's plain version, ``ref.ref_paged_decode``. On a CUDA tensor there is
no fallback: a build or launch failure raises. ``paged_decode_attention.
launches`` counts kernel launches (never plain-version calls).

``plan(bs, Dh, dtype)`` is the kernel's launch plan: a kv head's keys cut
into splits of ``split_keys`` (64) keys at fixed key multiples, whatever
the block size, query rows into tiles of 16, the splits of a tile over a
thread-block cluster. It never sees B, W, G, the valid lengths or the
table width, so a row's result does not depend on what shares its call.
The kernel checks the plan it is given against its own constants.

The kernel takes every head_dim from 1 to 256 (even ones on packed
pools: ``pack4`` splits a row at its true half), every block size from 1
to 128 and codebooks of up to 16 entries packed or 256 unpacked
(``shape_refusal``).

``pack4``/``unpack4`` keep the reference's split-half nibble layout byte
for byte (byte i holds code[i] low, code[i + D/2] high), so pools convert
between the two packages unchanged. The bytes models are the reference's,
unchanged: the analytic HBM reads the kernel's bound is taken from.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import build
from .ref import BIG_NEG, ref_paged_decode, unpack4

__all__ = ["BIG_NEG", "PaPlan", "kernel_smem", "pack4", "unpack4",
           "paged_decode_attention", "paged_prefill_attention", "plan",
           "shape_refusal",
           "modeled_hbm_bytes_per_token",
           "modeled_prefill_hbm_bytes_per_token"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BS_MAX, _DH_MAX, _L_MAX = 128, 256, 256    # the kernel's static limits
# the kernel's constants (csrc/paged_attention.cu)
SPLIT_KEYS = 64         # keys a split: 4 warps x 16
TILE_ROWS = 16          # query rows a tile (one m16 tile)
CLUSTER = 8             # blocks of a tile's cluster (the portable maximum)


class PaPlan(NamedTuple):
    """How the kernel cuts one kv head's work: keys into splits of
    ``split_keys`` keys, split s covering keys [s S, s S + S) (a page may
    straddle two splits); query rows into tiles of ``tile_rows``; the
    splits of a tile over a cluster of ``cluster`` blocks, rank r
    computing splits r, r + cluster, ..., their partials folded in split
    order."""
    split_keys: int
    tile_rows: int
    cluster: int

    def split_ranges(self, n_keys: int) -> list[tuple[int, int]]:
        """The key ranges [k0, k1) of the splits that cover n_keys."""
        S = self.split_keys
        return [(k, min(k + S, n_keys)) for k in range(0, n_keys, S)]

    def blocks(self, B: int, rows: int, Hkv: int) -> int:
        """Blocks launched for B sequences of ``rows`` query rows (W * G) a
        kv head."""
        return -(-rows // self.tile_rows) * self.cluster * Hkv * B


@functools.cache
def plan(bs: int, Dh: int, dtype: torch.dtype) -> PaPlan:
    """The launch plan for pages of ``bs`` keys: 64 keys a split (the 4
    warps of a block take 16 each), tiles of 16 rows, clusters of 8. bs,
    Dh and the dtype are the inputs a plan may read; today's plan reads
    none of them (they size only the block's shared memory,
    ``kernel_smem``, which fits at every plan)."""
    del bs, Dh, dtype
    return PaPlan(SPLIT_KEYS, TILE_ROWS, CLUSTER)


def pack4(codes: torch.Tensor) -> torch.Tensor:
    """Pack two 4-bit codes per byte along the last dim (must be even)."""
    D = codes.shape[-1]
    if D % 2:
        raise ValueError(f"pack4 needs an even last dim, got {D}")
    lo, hi = codes[..., : D // 2], codes[..., D // 2:]
    return lo.to(torch.uint8) | (hi.to(torch.uint8) << 4)


@functools.cache
def _lib():
    fn = build.load("paged_attention").paged_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def kernel_smem(pl: PaPlan, bs: int, Dh: int, L: int,
                dtype: torch.dtype) -> int:
    """Shared-memory bytes of a block of the kernel under plan ``pl``, as
    the kernel lays them out (builds the kernel)."""
    smem = build.load("paged_attention").paged_attention_smem(
        Dh, bs, L, pl.split_keys, pl.tile_rows, pl.cluster,
        _DTYPE_CODE[dtype])
    if smem < 0:
        raise ValueError(f"kernel_smem: no layout for bs={bs}, Dh={Dh}, "
                         f"L={L}, {pl}")
    return smem


def shape_refusal(head_dim: int, block_size: int,
                  num_values: int | None = None, *,
                  packed: bool = True) -> str | None:
    """Why the kernel refuses a pool of this geometry, or None if it takes
    it: head_dim 1 to 256 (even, when the codes are packed two a byte),
    block 1 to 128 keys, a codebook of at most 16 entries packed or 256
    unpacked (``num_values=None``: an fp pool, no codebook). The engine
    asks this before it routes a CUDA pool to the kernel."""
    if not 1 <= head_dim <= _DH_MAX:
        return f"head_dim {head_dim} (want 1 to {_DH_MAX})"
    if not 1 <= block_size <= _BS_MAX:
        return f"block size {block_size} (want 1 to {_BS_MAX} keys)"
    if num_values is not None:
        most, how = (16, "packed") if packed else (_L_MAX, "unpacked")
        if num_values > most:
            return f"codebook width {num_values} (want <= {most} {how})"
        if packed and head_dim % 2:
            return (f"head_dim {head_dim} on a packed pool (want an even "
                    f"head_dim: two codes a byte)")
    return None


def _fail(msg: str):
    raise ValueError(f"paged_decode_attention: {msg}")


def _launch(q, k_fp, v_fp, k_codes, v_codes, k_cb, v_cb, blk_q, block_table,
            kv_valid_len, *, softcap, quantized, packed, pl=None):
    """One kernel launch on q (B, W, Hq, Dh); ``pl`` replaces the plan
    (the cluster sweeps of the card tests and ``tools/pa_probe.py``).
    Every check formats its message only when it fails: a decode step
    makes one call per layer."""
    B, W, Hq, Dh = q.shape
    nb, bs, Hkv, _ = k_fp.shape
    dev = q.device
    if q.dtype not in _DTYPE_CODE:
        _fail(f"q dtype {q.dtype} (want f32 or bf16)")
    if k_fp.dtype != q.dtype or v_fp.dtype != q.dtype:
        _fail("k_fp/v_fp must have q's dtype")
    if not k_fp.shape == v_fp.shape == (nb, bs, Hkv, Dh):
        _fail(f"pool shape {tuple(k_fp.shape)} vs head_dim {Dh}")
    if Hq % Hkv:
        _fail(f"Hq {Hq} not a multiple of Hkv {Hkv}")
    refusal = shape_refusal(Dh, bs)
    if refusal:
        _fail(refusal)
    if (block_table.dtype != torch.int32 or block_table.dim() != 2
            or block_table.shape[0] != B):
        _fail("block_table must be (B, mb) int32")
    if kv_valid_len.dtype != torch.int32 or kv_valid_len.shape != (B,):
        _fail("kv_valid_len must be (B,) int32")
    mb = block_table.shape[1]
    args = [q, k_fp, v_fp, block_table, kv_valid_len]
    Dc, L = Dh, 1
    if quantized:
        Dc = Dh // 2 if packed else Dh
        L = k_cb.shape[1]
        if k_codes.dtype != torch.uint8 or v_codes.dtype != torch.uint8:
            _fail("codes must be uint8")
        if not k_codes.shape == v_codes.shape == (nb, bs, Hkv, Dc):
            _fail(f"codes shape {tuple(k_codes.shape)} (want "
                  f"{(nb, bs, Hkv, Dc)})")
        if k_cb.dtype != torch.float32 or not k_cb.shape == v_cb.shape == (
                nb, L):
            _fail("codebooks must be (nb, L) f32")
        refusal = shape_refusal(Dh, bs, L, packed=packed)
        if refusal:
            _fail(refusal)
        if blk_q.dtype not in (torch.bool, torch.uint8) or blk_q.shape != (
                nb,):
            _fail("blk_q must be (nb,) bool")
        args += [k_codes, v_codes, k_cb, v_cb, blk_q]
    for t in args:
        if t.device != dev:
            _fail(f"tensor on {t.device}, q on {dev}")
        if not t.is_contiguous():
            _fail("every tensor must be contiguous")
        if t.data_ptr() % 16:
            _fail("tensors must be 16-byte aligned")
    out = torch.empty_like(q)
    ptr = lambda t: t.data_ptr() if quantized else None
    pl = pl or plan(bs, Dh, q.dtype)
    rc = _lib()(
        q.data_ptr(), k_fp.data_ptr(), v_fp.data_ptr(), ptr(k_codes),
        ptr(v_codes), ptr(k_cb), ptr(v_cb), ptr(blk_q),
        block_table.data_ptr(), kv_valid_len.data_ptr(), out.data_ptr(),
        B, W, Hq, Hkv, Dh, nb, bs, mb, Dc, L,
        1.0 / math.sqrt(Dh), float(softcap or 0.0), int(quantized),
        int(packed), pl.split_keys, pl.tile_rows, pl.cluster,
        _DTYPE_CODE[q.dtype], _stream(dev))
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q, k_fp, v_fp, k_codes, v_codes, k_cb, v_cb,
                           blk_q, block_table, kv_valid_len, *, softcap=None,
                           quantized=False, packed=True):
    """Fused flash attention over the paged pools.

    ``q`` is one decode step (B, Hq, Dh) -> (B, Hq, Dh), or a window
    (B, W, Hq, Dh) -> (B, W, Hq, Dh) whose W queries sit at positions
    ``kv_valid_len - W .. kv_valid_len - 1`` (causal within the window).
    Pools are (nb, bs, Hkv, Dh); codes (nb, bs, Hkv, Dh/2 packed or Dh)
    uint8; codebooks (nb, L) f32; ``blk_q`` (nb,) marks pages served from
    codes; ``block_table`` (B, mb) int32 page ids (0 = null page);
    ``kv_valid_len`` (B,) int32, >= 1.
    """
    if q.device.type == "cpu":
        return ref_paged_decode(q, k_fp, v_fp, k_codes, v_codes, k_cb, v_cb,
                                blk_q, block_table, kv_valid_len,
                                softcap=softcap, quantized=quantized,
                                packed=packed)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for "
                         f"{q.device.type} tensors")
    windowed = q.dim() == 4
    q4 = q if windowed else q[:, None]
    out = _launch(q4.contiguous(), k_fp, v_fp, k_codes, v_codes, k_cb, v_cb,
                  blk_q, block_table, kv_valid_len, softcap=softcap,
                  quantized=quantized, packed=packed)
    return out if windowed else out[:, 0]


paged_decode_attention.launches = 0


def paged_prefill_attention(q, k_fp, v_fp, k_codes, v_codes, k_cb, v_cb,
                            blk_q, block_table, q_offset, *, softcap=None,
                            quantized=False, packed=True):
    """Fused chunked prefill: the chunk's C queries (B, C, Hq, Dh) sit at
    positions ``q_offset .. q_offset + C - 1`` (their K/V already written)
    and attend causally over every earlier page. This is the decode
    kernel's window with W = C and ``kv_valid_len = q_offset + C``."""
    if q.dim() != 4:
        raise ValueError("prefill queries are (B, C, Hq, Dh) chunks")
    valid = (q_offset + q.shape[1]).to(torch.int32)
    return paged_decode_attention(
        q, k_fp, v_fp, k_codes, v_codes, k_cb, v_cb, blk_q, block_table,
        valid, softcap=softcap, quantized=quantized, packed=packed)


# ------------------------------------------------------------ bytes model


def modeled_hbm_bytes_per_token(
    block_table, seq_lens, blk_q, *, block_size: int, n_kv_heads: int,
    head_dim: int, num_values: int, quantized: bool, packed: bool,
    path: str, fp_bytes: int = 4,
) -> float:
    """Analytic HBM read bytes per decoded token, one attention layer.

    ``seq_lens`` are pre-write lengths (the kernel sees valid = len + 1).
    The gather path materializes every table column at full width; the
    fused path reads, per sequence, only ``ceil((len+1)/bs)`` pages, each
    as codes + codebooks (frozen) or fp (hot). K and V both counted; q and
    the output are excluded (equal for both paths)."""
    table = np.asarray(block_table)
    lens = np.asarray(seq_lens)
    bq = np.asarray(blk_q).astype(bool).reshape(-1)
    B, mb = table.shape
    bs = block_size
    elems = bs * n_kv_heads * head_dim
    fp_page = 2 * elems * fp_bytes
    Dc = head_dim // 2 if packed else head_dim
    code_page = 2 * (bs * n_kv_heads * Dc + num_values * 4)
    if path == "gather":
        return float(mb * fp_page)
    if path != "fused":
        raise ValueError(path)
    total = 0
    for b in range(B):
        n_pages = -(-(int(lens[b]) + 1) // bs)
        for j in range(min(n_pages, mb)):
            frozen = quantized and bq[table[b, j]]
            total += code_page if frozen else fp_page
    return total / B


def modeled_prefill_hbm_bytes_per_token(
    block_table, prompt_lens, blk_q, *, chunk: int, block_size: int,
    n_kv_heads: int, head_dim: int, num_values: int, quantized: bool,
    packed: bool, path: str, fp_bytes: int = 4,
) -> float:
    """Analytic HBM read bytes per prompt token for chunked prefill, one
    attention layer: every chunk re-reads its prefix, the gather path at
    fp width over the whole table, the fused path only the
    ``ceil((off + C) / bs)`` pages covering it."""
    table = np.asarray(block_table)
    lens = np.asarray(prompt_lens)
    bq = np.asarray(blk_q).astype(bool).reshape(-1)
    B, mb = table.shape
    bs = block_size
    elems = bs * n_kv_heads * head_dim
    fp_page = 2 * elems * fp_bytes
    Dc = head_dim // 2 if packed else head_dim
    code_page = 2 * (bs * n_kv_heads * Dc + num_values * 4)
    total = 0
    n_tok = 0
    for b in range(B):
        P = int(lens[b])
        n_tok += P
        for off in range(0, P, chunk):
            C = min(chunk, P - off)
            if path == "gather":
                total += mb * fp_page
                continue
            if path != "fused":
                raise ValueError(path)
            n_pages = -(-(off + C) // bs)
            for j in range(min(n_pages, mb)):
                frozen = quantized and bq[table[b, j]]
                total += code_page if frozen else fp_page
    return total / max(n_tok, 1)
