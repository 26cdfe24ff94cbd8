"""Batched FISTA on the paper's eq.-6 l1 least squares (port of
``repro/kernels/fista_quant.py``).

``fista_quant(w, d, n, lam, eta, n_iters=...)`` runs ``n_iters`` FISTA
steps on B independent rows (one sparse-LSQ problem each, padded to
(nb, T) blocks): for CUDA tensors it launches the hand-written Hopper
kernel ``csrc/fista_quant.cu`` (one block per row, the row held on chip
for every step); for CPU tensors it runs the plain version,
``ref.ref_fista``. On a CUDA tensor there is no fallback: what the kernel
does not take raises. ``fista_quant.launches`` counts kernel launches
(never plain-version calls). The wrapper launches on the current stream
(a page freeze's side stream) and never synchronizes.

A row's result does not depend on the batch: a row solved alone equals
the same row among 224, bitwise, on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import ref_fista

__all__ = ["MP_MAX", "fista_quant"]

MP_MAX = 4096           # columns a row may have (csrc MP_MAX: 512 x 8)


@functools.cache
def _kernel():
    fn = build.load("fista_quant").fista_quant_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fista_quant(w: torch.Tensor, d: torch.Tensor, n: torch.Tensor,
                lam: torch.Tensor, eta: torch.Tensor, *,
                n_iters: int = 300) -> torch.Tensor:
    """alpha (B, nb, T) f32 after ``n_iters`` FISTA steps from alpha = 1.

    w: (B, nb, T) sorted unique values, zero-padded; d: column scales
    (0 on padding); n: weights (0 on padding); lam: per-column l1 penalty;
    eta: (B, 1, 1) step size 1/L per row. All f32."""
    B = w.shape[0]
    if w.device.type == "cpu":
        flat = lambda a: a.reshape(B, -1)
        return ref_fista(flat(w), flat(d), flat(n), flat(lam),
                         eta.reshape(B), n_iters=n_iters).reshape(w.shape)
    if w.device.type != "cuda":
        raise ValueError(f"fista_quant: no kernel for {w.device.type} "
                         f"tensors")
    if w.dim() != 3:
        raise ValueError(f"fista_quant: w must be (B, nb, T), got "
                         f"{tuple(w.shape)}")
    Mp = w.shape[1] * w.shape[2]
    rows = (w, d, n, lam)
    if any(a.shape != w.shape for a in rows) or eta.numel() != B:
        raise ValueError(f"fista_quant: shapes w/d/n/lam "
                         f"{[tuple(a.shape) for a in rows]}, eta "
                         f"{tuple(eta.shape)} do not match")
    if any(a.dtype != torch.float32 for a in rows + (eta,)):
        raise ValueError("fista_quant: every tensor must be f32")
    if any(a.device != w.device for a in rows + (eta,)):
        raise ValueError(f"fista_quant: tensors on "
                         f"{[str(a.device) for a in rows + (eta,)]}")
    if not all(a.is_contiguous() for a in rows + (eta,)):
        raise ValueError("fista_quant: every tensor must be contiguous")
    if Mp > MP_MAX:
        raise ValueError(f"fista_quant: rows of {Mp} columns (the kernel "
                         f"holds at most {MP_MAX})")
    if not isinstance(n_iters, int) or n_iters < 0:
        raise ValueError(f"fista_quant: n_iters {n_iters!r}")
    out = torch.empty_like(w)
    if B == 0 or Mp == 0:
        return out
    rc = _kernel()(w.data_ptr(), d.data_ptr(), n.data_ptr(), lam.data_ptr(),
                   eta.data_ptr(), out.data_ptr(), B, Mp, n_iters,
                   torch.cuda.current_stream(w.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fista_quant kernel launch failed: CUDA error "
                           f"{rc}")
    fista_quant.launches += 1
    return out


fista_quant.launches = 0
