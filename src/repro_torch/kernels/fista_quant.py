"""Batched FISTA on the paper's eq.-6 l1 least squares (port of
``repro/kernels/fista_quant.py``), and the iter_l1 page freeze's solve
around it (the power iteration and lambda bisection of the reference's
``repro/kernels/page_quant.py:_fista_pages``).

``fista_quant(w, d, n, lam, eta, n_iters=...)`` runs ``n_iters`` FISTA
steps on B independent rows (one sparse-LSQ problem each, padded to
(nb, T) blocks). ``fista_freeze(w, d, n, x0, num_values=...)`` runs a page
freeze's whole solve on R sketched rows of 128 columns: column scales,
``POWER_ITERS`` power iterations, ``lam_hi`` and ``BISECT_STEPS`` bisection steps of
``FISTA_ITERS`` FISTA steps each, and returns the support ``best`` (with
``eta`` and ``lam_hi``). For CUDA tensors both launch the hand-written
Hopper kernel ``csrc/fista_quant.cu`` once (its two entries); for CPU
tensors they run their plain versions, ``ref.ref_fista`` and
``freeze_plain`` (the torch composition, which launches ``fista_quant``
``BISECT_STEPS`` times on CUDA tensors). On a CUDA tensor there is no
fallback: what the kernel does not take raises. ``fista_quant.launches``
and ``fista_freeze.launches`` count kernel launches (never plain-version
calls). The wrappers launch on the current stream (a page freeze's side
stream) and never synchronize.

``plan(Mp)`` is how the kernel lays out rows of Mp columns: a row of up
to 128 columns is one warp, ``PAGE_ROWS`` rows a block; a wider row is
one block of a warp per 128-column chunk. The kernel derives it from Mp
alone, and its summation order depends on Mp alone, so a row's result
does not depend on the batch: a row solved alone equals the same row
among 224, bitwise, on the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build
from .ref import fsum, ref_fista, scan

__all__ = ["BISECT_STEPS", "FISTA_ITERS", "FqPlan", "MP_MAX", "fista_freeze", "fista_quant", "freeze_plain", "freeze_problem",
           "nnz_of", "plan", "start_vector"]

MP_MAX = 4096           # columns a row may have (csrc MP_MAX: 32 chunks)
CHUNK = 128             # columns a warp holds (csrc kChunk)
PAGE_ROWS = 4           # one-warp rows a block (csrc PAGE_ROWS)
FISTA_ITERS = 100       # FISTA steps per bisection step of a page freeze
BISECT_STEPS = 14       # lambda bisection steps of a page freeze
POWER_ITERS = 40        # power iterations of a page freeze


class FqPlan(NamedTuple):
    """How the kernel lays out rows of Mp columns: ``rows_per_block`` rows
    of one warp each (Mp <= 128), or one row a block of ``warps_per_row``
    warps, one per 128-column chunk."""
    rows_per_block: int
    warps_per_row: int

    def blocks(self, B: int) -> int:
        """Blocks launched for B rows."""
        return -(-B // self.rows_per_block)


def plan(Mp: int) -> FqPlan:
    """The kernel's layout for rows of ``Mp`` columns (the launch entry
    derives the same from Mp). The rows' count never enters it, so a
    row's bits never depend on the rows beside it."""
    chunks = -(-Mp // CHUNK)
    return FqPlan(PAGE_ROWS, 1) if chunks <= 1 else FqPlan(1, chunks)


@functools.cache
def _lib():
    lib = build.load("fista_quant")
    lib.fista_quant_launch.argtypes = ([ctypes.c_void_p] * 6
                                       + [ctypes.c_int] * 3
                                       + [ctypes.c_void_p])
    lib.fista_quant_launch.restype = ctypes.c_int
    lib.fista_freeze_launch.argtypes = ([ctypes.c_void_p] * 7
                                        + [ctypes.c_int] * 5
                                        + [ctypes.c_void_p])
    lib.fista_freeze_launch.restype = ctypes.c_int
    return lib


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check(name, tensors, shapes, dev):
    if any(a.dtype != torch.float32 for a in tensors):
        raise ValueError(f"{name}: every tensor must be f32")
    if any(a.device != dev for a in tensors):
        raise ValueError(f"{name}: tensors on "
                         f"{[str(a.device) for a in tensors]}")
    if [tuple(a.shape) for a in tensors] != shapes:
        raise ValueError(f"{name}: shapes "
                         f"{[tuple(a.shape) for a in tensors]} do not match "
                         f"{shapes}")
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous")


def _launch(w, d, n, lam, eta, *, n_iters: int):
    """One kernel launch on (B, nb, T) rows."""
    if w.dim() != 3:
        raise ValueError(f"fista_quant: w must be (B, nb, T), got "
                         f"{tuple(w.shape)}")
    B = w.shape[0]
    Mp = w.shape[1] * w.shape[2]
    _check("fista_quant", (w, d, n, lam, eta),
           [tuple(w.shape)] * 4 + [tuple(eta.shape)], w.device)
    if eta.numel() != B:
        raise ValueError(f"fista_quant: eta {tuple(eta.shape)} does not "
                         f"match the {B} rows")
    if Mp > MP_MAX:
        raise ValueError(f"fista_quant: rows of {Mp} columns (the kernel "
                         f"holds at most {MP_MAX})")
    if not isinstance(n_iters, int) or n_iters < 0:
        raise ValueError(f"fista_quant: n_iters {n_iters!r}")
    out = torch.empty_like(w)
    if B == 0 or Mp == 0:
        return out
    rc = _lib().fista_quant_launch(
        w.data_ptr(), d.data_ptr(), n.data_ptr(), lam.data_ptr(),
        eta.data_ptr(), out.data_ptr(), B, Mp, n_iters, _stream(w.device))
    if rc != 0:
        raise RuntimeError(f"fista_quant kernel launch failed: CUDA error "
                           f"{rc}")
    fista_quant.launches += 1
    return out


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
    return _launch(w, d, n, lam, eta, n_iters=n_iters)


fista_quant.launches = 0


# ---------------------------------------------------------------- freeze


@functools.cache
def _start_vector(width: int, device: torch.device):
    x = torch.sin(torch.arange(width, dtype=torch.float32, device=device)
                  + 1.0)[None]
    x = (x / (torch.sqrt(fsum(x * x))[:, None] + 1e-30))[0]
    ready = None
    if device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record()
    return x, ready


def start_vector(width: int, device) -> torch.Tensor:
    """The power iteration's start vector: ``sin(1..width)`` normalized
    (the reference's), the same for every row and every freeze. Made once
    per (width, device) and shared by every caller (read only); on a CUDA
    device the current stream first waits, on the card, for the stream
    that made it."""
    x, ready = _start_vector(width, torch.device(device))
    if ready is not None:
        torch.cuda.current_stream(x.device).wait_event(ready)
    return x


def nnz_of(alpha: torch.Tensor):
    """Distinct reconstruction levels of each row's support: its size,
    +1 for the implicit zero level when the first column is off it."""
    sup = alpha.abs() > 1e-12
    return sup.sum(1) + (1 - sup[:, 0].long()), sup


def _suffix_sum(x: torch.Tensor) -> torch.Tensor:
    cums = scan(x)
    return cums[:, -1:] - cums + x


def freeze_problem(w: torch.Tensor, d: torch.Tensor, n: torch.Tensor,
                   x0: torch.Tensor) -> dict:
    """The preconditioned eq.-6 problem of each sketched row (R, Mp) and
    its step size: the column ``scale`` (unit column norms, the transform
    of ``ops.solve_fista_batch``: the same problem with a ~14x lower
    Lipschitz constant) and the scaled columns ``dt``; ``eta`` (R, 1, 1)
    from POWER_ITERS power iterations from ``x0``; ``lam_hi`` (R,), a
    lambda above which alpha = 0. Torch ops in fixed orders (``scan``,
    ``fsum``), as the freeze kernel computes them."""
    R = w.shape[0]
    nsuf = scan(n.flip(1)).flip(1)
    z = d * d * nsuf
    scale = torch.sqrt(torch.where(z <= 0, torch.ones_like(z), z))
    dt = d / scale
    x = x0.expand(R, -1)
    lip = torch.ones(R, dtype=torch.float32, device=w.device)
    for _ in range(POWER_ITERS):   # x -> V^T diag(n) V x, in cumsum form
        y = dt * _suffix_sum(n * scan(x * dt))
        xy_yy = fsum(torch.stack([x * y, y * y]), dim=2)
        lip = torch.clamp_min(xy_yy[0], 1e-30)
        x = y / (torch.sqrt(xy_yy[1])[:, None] + 1e-30)
    # alpha == 0 above max |gradient at 0| in the original coordinates
    # (the threshold is lam / scale and the gradient scales by 1 / scale)
    g0 = d * _suffix_sum(n * w)
    lam_hi = g0.abs().amax(dim=1) * 1.001 + 1e-12
    return dict(dt=dt, scale=scale, lam_hi=lam_hi,
                eta=(1.0 / (lip * 1.01)).reshape(R, 1, 1))


def freeze_plain(w: torch.Tensor, d: torch.Tensor, n: torch.Tensor,
                 x0: torch.Tensor, *, num_values: int,
                 n_iters: int = FISTA_ITERS,
                 bisect_steps: int = BISECT_STEPS):
    """The plain version of ``fista_freeze``: ``freeze_problem``, then
    ``bisect_steps`` bisection steps, each one ``fista_quant`` call
    (``n_iters`` steps) on every row; keeps, per row, the smallest lambda
    whose l1 support fits ``num_values`` levels (the count is
    non-increasing in lambda). Returns (best (R, Mp), eta (R, 1, 1),
    lam_hi (R,))."""
    R = w.shape[0]
    pr = freeze_problem(w, d, n, x0)
    dt, scale, eta = pr["dt"], pr["scale"], pr["eta"]
    blk = lambda a: a.reshape(R, -1, CHUNK)
    live = (n > 0).float()
    lo = torch.zeros_like(pr["lam_hi"])
    hi = pr["lam_hi"]
    best = torch.zeros_like(w)
    for _ in range(bisect_steps):
        mid = 0.5 * (lo + hi)
        # lambda scales by 1 / scale like d does: the penalty stays
        # lambda * |alpha| in the original coordinates
        lam = mid[:, None] / scale * live
        alpha = fista_quant(blk(w), blk(dt), blk(n), blk(lam), eta,
                            n_iters=n_iters).reshape(R, -1)
        feas = nnz_of(alpha)[0] <= num_values
        lo = torch.where(feas, lo, mid)
        hi = torch.where(feas, mid, hi)
        best = torch.where(feas[:, None], alpha, best)
    return best, eta, pr["lam_hi"]


def _launch_freeze(w, d, n, x0, *, num_values: int, n_iters: int,
                   bisect_steps: int):
    """One launch of the kernel's freeze entry on (R, 128) rows."""
    R = w.shape[0]
    _check("fista_freeze", (w, d, n, x0), [(R, CHUNK)] * 3 + [(CHUNK,)],
           w.device)
    for name, v, least in (("num_values", num_values, 1),
                           ("n_iters", n_iters, 0),
                           ("bisect_steps", bisect_steps, 0)):
        if not isinstance(v, int) or v < least:
            raise ValueError(f"fista_freeze: {name} {v!r}")
    best = torch.empty_like(w)
    eta = w.new_empty((R, 1, 1))
    lam_hi = w.new_empty((R,))
    if R == 0:
        return best, eta, lam_hi
    rc = _lib().fista_freeze_launch(
        w.data_ptr(), d.data_ptr(), n.data_ptr(), x0.data_ptr(),
        best.data_ptr(), eta.data_ptr(), lam_hi.data_ptr(), R, num_values,
        n_iters, bisect_steps, POWER_ITERS, _stream(w.device))
    if rc != 0:
        raise RuntimeError(f"fista_freeze kernel launch failed: CUDA error "
                           f"{rc}")
    fista_freeze.launches += 1
    return best, eta, lam_hi


def fista_freeze(w: torch.Tensor, d: torch.Tensor, n: torch.Tensor,
                 x0: torch.Tensor, *, num_values: int,
                 n_iters: int = FISTA_ITERS,
                 bisect_steps: int = BISECT_STEPS):
    """A page freeze's solve on R sketched rows: w the padded sketch
    (R, 128), d its differences, n its weights (0 on padding), x0 the
    start vector (``start_vector(128, device)``); all f32. Returns
    (best (R, 128), eta (R, 1, 1), lam_hi (R,)), as ``freeze_plain``."""
    if w.device.type == "cpu":
        return freeze_plain(w, d, n, x0, num_values=num_values,
                            n_iters=n_iters, bisect_steps=bisect_steps)
    if w.device.type != "cuda":
        raise ValueError(f"fista_freeze: no kernel for {w.device.type} "
                         f"tensors")
    return _launch_freeze(w, d, n, x0, num_values=num_values,
                          n_iters=n_iters, bisect_steps=bisect_steps)


fista_freeze.launches = 0
