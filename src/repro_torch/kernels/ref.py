"""Plain PyTorch versions of the port's kernels (port of
``repro/kernels/ref.py``): what each wrapper runs for CPU tensors, and
what ``chip_smoke.py`` holds the CUDA kernels against.

- ``ref_paged_decode`` materializes every table page at full width
  (dequantizing frozen pages), then a masked softmax.
- ``ref_quant_matmul`` / ``ref_quant_matmul_stacked`` materialize
  ``W = codebook[idx]`` rounded to x's dtype, then multiply in f32 (exact
  products of bf16 operands, f32 sums: the reference's
  ``preferred_element_type=f32``) and round once to the output dtype.
- ``ref_fista`` runs the FISTA iterates of ``fista_quant`` on (B, M) rows
  with ``torch.cumsum`` for both scans.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

BIG_NEG = -2.3819763e38


def ref_quant_matmul(x, idx, codebook, out_dtype=None):
    """y = x @ codebook[idx]: x (M, K), idx (K, N) codes, codebook (L,)."""
    w = codebook[idx.long()].to(x.dtype)
    return (x.float() @ w.float()).to(out_dtype or x.dtype)


def ref_quant_matmul_stacked(x, idx, codebook, out_dtype=None):
    """y[g] = x[g] @ codebook[g][idx[g]]: x (G, M, K), idx (G, K, N),
    codebook (G, L)."""
    G = idx.shape[0]
    w = torch.take_along_dim(codebook, idx.reshape(G, -1).long(), dim=1)
    w = w.reshape(idx.shape).to(x.dtype)
    return torch.bmm(x.float(), w.float()).to(out_dtype or x.dtype)


def unpack4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack4``: (..., Dc) uint8 -> (..., 2*Dc) int64 codes."""
    lo = (packed & 0xF).long()
    hi = (packed >> 4).long()
    return torch.cat([lo, hi], dim=-1)


def ref_paged_decode(q, k_fp, v_fp, k_codes, v_codes, k_cb, v_cb, blk_q,
                     block_table, kv_valid_len, *, softcap=None,
                     quantized=False, packed=True):
    """``q`` is (B, Hq, Dh) for one decode step, or (B, W, Hq, Dh) for a
    window whose query w sits at position ``kv_valid_len - W + w`` (causal
    within the window)."""
    windowed = q.dim() == 4
    if not windowed:
        q = q[:, None]
    B, W, Hq, Dh = q.shape
    nb, bs, Hkv, _ = k_fp.shape
    G = Hq // Hkv
    t = block_table.long()
    mb = t.shape[1]

    def expand(fp, codes, cb):
        pages = fp[t]                                  # (B, mb, bs, H, D)
        if quantized:
            c = codes[t]
            c = unpack4(c) if packed else c.long()
            deq = torch.take_along_dim(
                cb[t], c.reshape(B, mb, -1), dim=-1).reshape(c.shape)
            frozen = blk_q.bool()[t][:, :, None, None, None]
            pages = torch.where(frozen, deq.to(pages.dtype), pages)
        return pages.reshape(B, mb * bs, Hkv, Dh)

    k_all = expand(k_fp, k_codes, k_cb).float()
    v_all = expand(v_fp, v_codes, v_cb).float()
    qr = q.float().reshape(B, W, Hkv, G, Dh)
    s = torch.einsum("bwhgd,bshd->bwhgs", qr, k_all) / math.sqrt(Dh)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(mb * bs, device=q.device)[None, None]
    valid = kv_valid_len.to(device=q.device, dtype=torch.int64)[:, None, None]
    valid_w = valid - (W - 1 - torch.arange(W, device=q.device)[None, :,
                                                                  None])
    mask = (pos < valid_w)[:, :, None, None]           # (B, W, 1, 1, S)
    s = torch.where(mask, s, torch.tensor(BIG_NEG, device=q.device))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, torch.zeros((), device=q.device))
    out = torch.einsum("bwhgs,bshd->bwhgd", p, v_all)
    out = out.reshape(B, W, Hq, Dh).to(q.dtype)
    return out if windowed else out[:, 0]


@functools.cache
def fista_momentum(n_iters: int) -> tuple[float, ...]:
    """FISTA's momentum coefficients (t_i - 1) / t_{i+1}, t_0 = 1,
    t_{i+1} = (1 + sqrt(1 + 4 t_i^2)) / 2, in f32 as the reference's
    kernel computes them (the CUDA kernel computes the same sequence with
    round-to-nearest intrinsics)."""
    f = np.float32
    t, out = f(1.0), []
    for _ in range(n_iters):
        t_next = f(0.5) * (f(1.0) + np.sqrt(f(1.0) + f(4.0) * t * t))
        out.append(float((t - f(1.0)) / t_next))
        t = t_next
    return tuple(out)


def ref_fista(w, d, n, lam, eta, *, n_iters: int = 300):
    """FISTA with the iterates of ``fista_quant`` on (B, M) f32 rows:
    w, d, n, lam (B, M) and eta (B,) or (B, 1[, 1]). Starts from
    x = y = 1 and returns x after ``n_iters`` steps."""
    B = w.shape[0]
    eta = eta.reshape(B, 1)
    x_prev = y = torch.ones_like(w)
    for c in fista_momentum(n_iters):
        recon = torch.cumsum(y * d, dim=1)
        r = n * (w - recon)
        cums = torch.cumsum(r, dim=1)
        suffix = cums[:, -1:] - cums + r
        grad = -d * suffix
        v = y - eta * grad
        x = torch.sign(v) * torch.clamp_min(v.abs() - eta * lam, 0.0)
        y = x + c * (x - x_prev)
        x_prev = x
    return x_prev
