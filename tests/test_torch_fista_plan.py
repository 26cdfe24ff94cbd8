"""The FISTA kernel's launch plan (``repro_torch.kernels.fista_quant.plan``)
and its wrappers on the CPU: the plan reads Mp alone and gives every chunk
of a row a warp; the wrappers' launch arguments with the kernel replaced
by a recorder; the page freeze's plain route against the composition it
replaced, bitwise; and the aten ops one CUDA-routed freeze dispatches
(the launch stubbed). The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""
import importlib
import inspect

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels.ref import fsum, scan

fq = importlib.import_module("repro_torch.kernels.fista_quant")
pq = importlib.import_module("repro_torch.kernels.page_quant")

torch.set_num_threads(1)

WIDTHS = [1, 5, 100, 127, 128, 129, 256, 300, 1000, 2048, 4000, 4096]
# aten ops one freeze of 224 rows x 2048 values may dispatch on the CUDA
# route: the sort, the sketch, the refit and the wrapper's outputs
# (measured 170). The composition it replaced dispatches 4,415 with the
# start vector made beforehand (test_composed_freeze_dispatched_thousands_
# of_ops).
FREEZE_OPS_BOUND = 200


def test_plan_reads_mp_alone():
    assert list(inspect.signature(fq.plan).parameters) == ["Mp"]


@pytest.mark.parametrize("Mp", WIDTHS)
def test_plan_gives_every_chunk_a_warp_and_every_block_a_chunk(Mp):
    chunks = -(-Mp // fq.CHUNK)
    pl = fq.plan(Mp)
    assert pl.rows_per_block * pl.warps_per_row <= 32
    if chunks == 1:
        assert pl == (fq.PAGE_ROWS, 1)
        assert pl.blocks(224) == -(-224 // fq.PAGE_ROWS)
    else:
        assert pl == (1, chunks)
        assert pl.blocks(224) == 224


def _record(monkeypatch):
    """Replace the kernel library and the stream with recorders, so the
    wrappers' CUDA route runs on CPU tensors and returns what it would
    pass."""
    calls = []

    class Lib:
        def fista_quant_launch(self, *a):
            calls.append(("quant", a))
            return 0

        def fista_freeze_launch(self, *a):
            calls.append(("freeze", a))
            return 0

    monkeypatch.setattr(fq, "_lib", lambda: Lib())
    monkeypatch.setattr(fq, "_stream", lambda dev: 7)
    monkeypatch.setattr(fq.fista_quant, "launches", fq.fista_quant.launches)
    monkeypatch.setattr(fq.fista_freeze, "launches",
                        fq.fista_freeze.launches)
    return calls


def _rows(B, nb, T, seed=0):
    rng = np.random.default_rng(seed)
    w, d, n, lam = (torch.from_numpy(rng.normal(size=(B, nb, T)).astype(
        np.float32)) for _ in range(4))
    return w, d, n, lam, torch.ones(B, 1, 1)


@pytest.mark.parametrize("B,nb,T", [(224, 1, 128), (7, 32, 128), (3, 1, 100),
                                    (1, 3, 128), (2, 1, 1)])
def test_wrapper_passes_sizes(monkeypatch, B, nb, T):
    calls = _record(monkeypatch)
    args = _rows(B, nb, T)
    n0 = fq.fista_quant.launches
    out = fq._launch(*args, n_iters=37)
    (kind, a), = calls
    assert kind == "quant" and fq.fista_quant.launches == n0 + 1
    assert out.shape == (B, nb, T) and out.dtype == torch.float32
    assert a[:6] == tuple(t.data_ptr() for t in args + (out,))
    assert a[6:] == (B, nb * T, 37, 7)


def test_freeze_wrapper_passes_sizes_and_the_counts(monkeypatch):
    calls = _record(monkeypatch)
    w, d, n = (torch.rand(9, 128) for _ in range(3))
    x0 = fq.start_vector(128, "cpu")
    f0 = fq.fista_freeze.launches
    best, eta, lam_hi = fq._launch_freeze(w, d, n, x0, num_values=16,
                                          n_iters=100, bisect_steps=14)
    (kind, a), = calls
    assert kind == "freeze" and fq.fista_freeze.launches == f0 + 1
    assert (best.shape, eta.shape, lam_hi.shape) == ((9, 128), (9, 1, 1),
                                                      (9,))
    assert a[:7] == tuple(t.data_ptr() for t in (w, d, n, x0, best, eta,
                                                 lam_hi))
    assert a[7:] == (9, 16, 100, 14, fq.POWER_ITERS, 7)


def test_wrappers_reject_what_the_kernel_does_not_take(monkeypatch):
    calls = _record(monkeypatch)
    args = _rows(4, 1, 128)
    with pytest.raises(ValueError, match="f32"):
        fq._launch(*[a.double() for a in args], n_iters=3)
    with pytest.raises(ValueError, match="do not match"):
        fq._launch(args[0][:2], *args[1:], n_iters=3)
    with pytest.raises(ValueError, match="at most 4096"):
        fq._launch(*_rows(2, 33, 128)[:4], torch.ones(2), n_iters=3)
    with pytest.raises(ValueError, match="n_iters"):
        fq._launch(*args, n_iters=-1)
    w = torch.rand(4, 128)
    x0 = fq.start_vector(128, "cpu")
    with pytest.raises(ValueError, match="do not match"):
        fq._launch_freeze(w[:, :100], w, w, x0, num_values=16, n_iters=1,
                          bisect_steps=1)
    with pytest.raises(ValueError, match="num_values"):
        fq._launch_freeze(w, w, w, x0, num_values=0, n_iters=1,
                          bisect_steps=1)
    assert calls == []
    with pytest.raises(ValueError, match="no kernel for meta"):
        fq.fista_freeze(*(torch.empty(1, 128, device="meta")
                          for _ in range(4)), num_values=16)


# ------------------------------------------- the freeze before one launch

def _old_quantize_pages_fista(rows, *, num_values):
    """The page freeze as one torch composition with a launch per
    bisection step (the port's code before the freeze had its own launch),
    kept here as the reference the refactored plain route must equal."""
    L = num_values
    rows = rows.float()
    R, E = rows.shape
    svals = torch.sort(rows, dim=1).values
    Es = min(E, 128)
    s = svals[:, pq._sketch_positions(E, Es, rows.device)]
    pad = (0, 128 - Es)
    F = torch.nn.functional
    w = F.pad(s, pad)
    d = F.pad(torch.diff(s, dim=1, prepend=s.new_zeros(R, 1)), pad)
    n = F.pad(torch.full((R, Es), E / Es, dtype=torch.float32), pad)
    nsuf = scan(n.flip(1)).flip(1)
    z = d * d * nsuf
    scale = torch.sqrt(torch.where(z <= 0, torch.ones_like(z), z))
    dt = d / scale
    suffix = lambda x: scan(x)[:, -1:] - scan(x) + x
    x = torch.sin(torch.arange(128, dtype=torch.float32) + 1.0).expand(R, 128)
    x = x / (torch.sqrt(fsum(x * x))[:, None] + 1e-30)
    for _ in range(40):
        y = dt * suffix(n * scan(x * dt))
        xy_yy = fsum(torch.stack([x * y, y * y]), dim=2)
        lip = torch.clamp_min(xy_yy[0], 1e-30)
        x = y / (torch.sqrt(xy_yy[1])[:, None] + 1e-30)
    eta = (1.0 / (lip * 1.01)).reshape(R, 1, 1)
    lam_hi = (d * suffix(n * w)).abs().amax(dim=1) * 1.001 + 1e-12
    live = (n > 0).float()
    lo, hi, best = torch.zeros_like(lam_hi), lam_hi, torch.zeros_like(w)
    blk = lambda a: a.reshape(R, 1, 128)
    for _ in range(14):
        mid = 0.5 * (lo + hi)
        lam = mid[:, None] / scale * live
        alpha = fq.fista_quant(blk(w), blk(dt), blk(n), blk(lam), eta,
                               n_iters=100).reshape(R, -1)
        sup = alpha.abs() > 1e-12
        feas = sup.sum(1) + (1 - sup[:, 0].long()) <= L
        lo = torch.where(feas, lo, mid)
        hi = torch.where(feas, mid, hi)
        best = torch.where(feas[:, None], alpha, best)
    sup = best.abs() > 1e-12
    lid = torch.clamp(torch.cumsum(sup.long(), dim=1) - sup[:, :1].long(),
                      0, L - 1)
    ohn = (lid[:, :, None] == torch.arange(L)).float() * n[:, :, None]
    num, den = fsum(w[:, :, None] * ohn), fsum(ohn)
    mean = torch.where(den > 0, num / den.clamp_min(1e-20),
                       torch.full_like(num, -1e30))
    first = torch.where(den[:, :1] > 0, mean[:, :1], s[:, :1])
    centers = torch.cummax(torch.cat([first, mean[:, 1:]], dim=1),
                           dim=1).values
    idx = pq._assign(rows, centers)
    return idx.to(torch.uint8), pq._seg_mean(svals, centers, L)


@pytest.mark.parametrize("R,E,L", [(6, 2048, 16), (5, 100, 64), (3, 128, 16),
                                   (4, 300, 8)])
def test_plain_freeze_is_the_composition_it_replaced(R, E, L):
    rng = np.random.default_rng(R * E)
    rows = rng.normal(size=(R, E)).astype(np.float32)
    rows[::2] *= 3.0
    rows = torch.from_numpy(rows)
    codes, cb = pq.quantize_pages_fista(rows, num_values=L)
    old_codes, old_cb = _old_quantize_pages_fista(rows, num_values=L)
    assert torch.equal(codes, old_codes) and torch.equal(cb, old_cb)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def _freeze_rows():
    rng = np.random.default_rng(11)
    return torch.from_numpy(rng.normal(size=(224, 2048)).astype(np.float32))


def test_cuda_routed_freeze_dispatches_few_ops(monkeypatch):
    """One freeze of 224 rows on the CUDA route (the launch stubbed by the
    recorder): one launch of the freeze entry, at most FREEZE_OPS_BOUND
    aten ops (the start vector is made once per device beforehand)."""
    calls = _record(monkeypatch)
    monkeypatch.setattr(pq, "fista_freeze", lambda *a, **k: fq._launch_freeze(
        *a, n_iters=fq.FISTA_ITERS, bisect_steps=fq.BISECT_STEPS, **k))
    rows = _freeze_rows()
    fq.start_vector(128, rows.device)
    with _CountOps() as count:
        codes, cb = pq.quantize_pages_fista(rows, num_values=16)
    assert [k for k, _ in calls] == ["freeze"]
    assert codes.shape == rows.shape and cb.shape == (224, 16)
    assert 0 < count.ops <= FREEZE_OPS_BOUND, count.ops


def test_composed_freeze_dispatched_thousands_of_ops(monkeypatch):
    """What the one launch replaced: the composition (freeze_plain with
    fista_quant's CUDA route stubbed) dispatches BISECT_STEPS launches and
    over 4,000 aten ops for the same freeze."""
    calls = _record(monkeypatch)

    def cuda_route(*a, n_iters):
        return fq._launch(*a, n_iters=n_iters)

    cuda_route.launches = 0
    monkeypatch.setattr(fq, "fista_quant", cuda_route)
    monkeypatch.setattr(pq, "fista_freeze", fq.freeze_plain)
    rows = _freeze_rows()
    fq.start_vector(128, rows.device)
    with _CountOps() as count:
        pq.quantize_pages_fista(rows, num_values=16)
    assert [k for k, _ in calls] == ["quant"] * fq.BISECT_STEPS
    assert count.ops > 4000, count.ops
