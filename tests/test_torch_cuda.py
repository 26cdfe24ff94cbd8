"""The hand-written CUDA kernels against their plain PyTorch versions, at
small shapes (paged attention at the reduced config's Dh 32, block 8).
Needs an NVIDIA GPU and nvcc: CUDA kernels have no interpret mode, so
without a card these tests skip. Run them on the card with ``python -m
pytest -q -m cuda tests/test_torch_cuda.py`` (this file imports no JAX).

Tolerance: paged attention atol 2e-5 / rtol 1e-4 at f32 (the reference's
kernel bar); quant_matmul and fista_quant below.
"""
import pytest
import torch

from repro_torch.kernels import (pack4, paged_decode_attention,
                                 paged_prefill_attention, quant_matmul,
                                 quant_matmul_stacked, ref_paged_decode,
                                 ref_quant_matmul, ref_quant_matmul_stacked)
from repro_torch.core import QuantizedTensor
from repro_torch.kernels import (fista_quant, power_iter_lipschitz,
                                 quantize_pages_fista, ref_fista,
                                 solve_fista_batch)
from repro_torch.kernels.ops import fista_batch_problem
from repro_torch.kernels.page_quant import fista_page_problem
from repro_torch.quant import fallback_count, qmatmul

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _pool(gen, nb=9, bs=8, Hkv=2, Dh=32, L=16):
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    codes = torch.randint(0, L, (2, nb, bs, Hkv, Dh), generator=gen,
                          device="cuda", dtype=torch.uint8)
    blk_q = torch.zeros(nb, dtype=torch.bool, device="cuda")
    blk_q[[1, 4, 5]] = True
    return [rnd(nb, bs, Hkv, Dh), rnd(nb, bs, Hkv, Dh), pack4(codes[0]),
            pack4(codes[1]), rnd(nb, L), rnd(nb, L), blk_q]


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_decode_kernel_matches_plain(gen, softcap):
    state = _pool(gen)
    table = torch.tensor([[1, 2, 3], [4, 5, 6], [0, 0, 0]], dtype=torch.int32,
                         device="cuda")
    valid = torch.tensor([24, 11, 1], dtype=torch.int32, device="cuda")
    q = torch.randn(3, 4, 32, generator=gen, device="cuda")
    kw = dict(softcap=softcap, quantized=True, packed=True)
    out = paged_decode_attention(q, *state, table, valid, **kw)
    ref = ref_paged_decode(q, *state, table, valid, **kw)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=1e-4)


def test_prefill_kernel_chunks_are_bitwise_whole(gen):
    state = _pool(gen)
    table = torch.tensor([[2, 3, 4, 6]], dtype=torch.int32, device="cuda")
    q = torch.randn(1, 30, 4, 32, generator=gen, device="cuda")
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    whole = paged_prefill_attention(q, *state, table, zero, quantized=True)
    parts = torch.cat([paged_prefill_attention(
        q[:, o:o + 7], *state, table, zero + o, quantized=True)
        for o in range(0, 30, 7)], dim=1)
    assert torch.equal(whole, parts)
    ref = ref_paged_decode(q, *state, table, zero + 30, quantized=True)
    torch.testing.assert_close(whole, ref, atol=2e-5, rtol=1e-4)


def test_wrapper_rejects_what_the_kernel_does_not_take(gen):
    state = _pool(gen)
    q = torch.randn(1, 4, 32, generator=gen, device="cuda")
    table = torch.tensor([[1]], dtype=torch.int64, device="cuda")
    valid = torch.tensor([3], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention(q, *state, table, valid, quantized=True)


# ------------------------------------------------------------ quant_matmul
# Tolerances: f32 1e-4 (the reference's bar, tests/test_kernels.py); bf16:
# kernel and plain version both sum exact products in f32 and round once
# to bf16, so they differ by a bf16 ulp or two (rtol 2^-6).

_QMM_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
            torch.bfloat16: dict(atol=1e-5, rtol=2.0 ** -6)}


def _qmm_inputs(gen, M, K, N, L=16, dtype=torch.float32, G=None,
                idx_dtype=torch.uint8):
    lead = () if G is None else (G,)
    x = torch.randn(*lead, M, K, generator=gen, device="cuda").to(dtype)
    idx = torch.randint(0, L, (*lead, K, N), generator=gen, device="cuda",
                        dtype=torch.int64).to(idx_dtype)
    cb = torch.randn(*lead, L, generator=gen, device="cuda") / K ** 0.5
    return x, idx, cb


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(5, 33, 17), (4, 128, 64), (64, 96, 80)])
def test_quant_matmul_kernel_matches_plain(gen, M, K, N, dtype):
    x, idx, cb = _qmm_inputs(gen, M, K, N, dtype=dtype)
    n0 = quant_matmul.launches
    out = quant_matmul(x, idx, cb)
    assert quant_matmul.launches == n0 + 1 and out.dtype == dtype
    torch.testing.assert_close(out.float(),
                               ref_quant_matmul(x, idx, cb).float(),
                               **_QMM_TOL[dtype])


def test_quant_matmul_int32_codes_large_codebook(gen):
    x, idx, cb = _qmm_inputs(gen, 16, 64, 32, L=1000,
                             idx_dtype=torch.int32)
    torch.testing.assert_close(quant_matmul(x, idx, cb),
                               ref_quant_matmul(x, idx, cb),
                               **_QMM_TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_rows_are_bitwise_independent_of_m(gen, dtype):
    """Rows of an M=64 call equal the same rows at M=1 and M=4."""
    x, idx, cb = _qmm_inputs(gen, 64, 256, 192, dtype=dtype)
    full = quant_matmul(x, idx, cb)
    for m in (1, 4):
        for r0 in (0, 13, 60):
            assert torch.equal(quant_matmul(x[r0:r0 + m], idx, cb),
                               full[r0:r0 + m])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_stacked_matches_plain_and_flat(gen, dtype):
    x, idx, cb = _qmm_inputs(gen, 5, 17, 9, G=3, dtype=dtype)
    n0 = quant_matmul_stacked.launches
    out = quant_matmul_stacked(x, idx, cb)
    assert quant_matmul_stacked.launches == n0 + 1
    torch.testing.assert_close(
        out.float(), ref_quant_matmul_stacked(x, idx, cb).float(),
        **_QMM_TOL[dtype])
    for g in range(3):      # one kernel body: each group bitwise the flat
        assert torch.equal(out[g], quant_matmul(x[g], idx[g], cb[g]))


@pytest.mark.parametrize("L,idx_dtype", [(16, torch.uint8),
                                         (1000, torch.int32)])
def test_quant_matmul_bf16_rounds_the_gathered_weight(gen, L, idx_dtype):
    """x = diag(v) in bf16: each output is one exact f32 product, so the
    kernel must give v * bf16(codebook[idx]) rounded to bf16 bit for bit.
    A kernel that multiplies the f32 codebook value differs in the last
    bit of most entries."""
    K = N = 256
    v = torch.randn(K, generator=gen, device="cuda")
    x = torch.diag(v).to(torch.bfloat16)
    idx = torch.randint(0, L, (K, N), generator=gen, device="cuda",
                        dtype=torch.int64).to(idx_dtype)
    cb = torch.randn(L, generator=gen, device="cuda")
    w = cb[idx.long()]
    want = (x.float().diagonal()[:, None]
            * w.to(torch.bfloat16).float()).to(torch.bfloat16)
    assert not torch.equal(
        want, (x.float().diagonal()[:, None] * w).to(torch.bfloat16))
    assert torch.equal(quant_matmul(x, idx, cb), want)


def test_qmatmul_stacked_weight_without_group_axis_uses_the_kernel(gen):
    """x (M, K) against a stacked weight: one stacked launch over x copied
    to every group, no dense fallback, each group bitwise the flat
    kernel."""
    G, M, K, N = 3, 4, 64, 48
    x, idx, cb = _qmm_inputs(gen, M, K, N, G=G, dtype=torch.bfloat16)
    w = QuantizedTensor(cb, idx.reshape(G, -1), (K, N), torch.bfloat16)
    n0, f0 = quant_matmul_stacked.launches, fallback_count()
    out = qmatmul(x[0], w)
    assert quant_matmul_stacked.launches == n0 + 1
    assert fallback_count() == f0 and out.shape == (G, M, N)
    for g in range(G):
        assert torch.equal(out[g], quant_matmul(x[0], idx[g], cb[g]))


def test_quant_matmul_wrapper_rejects_what_the_kernel_does_not_take(gen):
    x, idx, cb = _qmm_inputs(gen, 4, 64, 32)
    with pytest.raises(ValueError, match="codes dtype"):
        quant_matmul(x, idx.long(), cb)
    with pytest.raises(ValueError, match="x dtype"):
        quant_matmul(x.half(), idx, cb)
    with pytest.raises(ValueError, match="contiguous"):
        quant_matmul(x, idx.t().contiguous().t(), cb)
    with pytest.raises(ValueError, match="do not match"):
        quant_matmul(x[:, :32], idx, cb)
    with pytest.raises(ValueError, match="codebook dtype"):
        quant_matmul(x, idx, cb.double())
    with pytest.raises(ValueError, match="writes x's dtype"):
        quant_matmul(x, idx, cb, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="x on"):
        quant_matmul(x, idx.cpu(), cb)


# ------------------------------------------------------------ fista_quant
# Tolerance: atol 2e-4 / rtol 1e-3, the reference's kernel bar
# (tests/test_kernels.py:67): the kernel's block scans and torch.cumsum add
# in different orders. On preconditioned PTQ rows f32 FISTA after 1000
# steps depends on that order beyond the bar (two f32 plain versions do on
# the CPU: tests/test_torch_fista.py), so those rows are held by the eq.-6
# objective the two reach, within 1e-3 of each other, and by the kernel's
# distance from a float64 run, at most 3x the f32 plain version's.


def _page_inputs(gen, R=224, E=2048):
    """The page freeze's kernel inputs: R sketched rows (Mp = 128) at a
    lambda halfway to each row's lam_hi, as in a bisection step."""
    rows = torch.randn(R, E, generator=gen, device="cuda")
    rows[::3] *= torch.linspace(0.1, 3.0, E, device="cuda")
    p = fista_page_problem(rows)
    lam = (0.5 * p["lam_hi"])[:, None] / p["scale"] * (p["n"] > 0)
    blk = lambda a: a.reshape(R, 1, 128).contiguous()
    return (blk(p["w"]), blk(p["dt"]), blk(p["n"]), blk(lam), p["eta"])


def _ptq_inputs(gen, B=7, M=4096, weighted=False):
    """Kernel inputs at batched PTQ's shape: the reference kernel test's
    (sorted normal rows, unit weights, lambda 0.05, no preconditioning),
    or rows weighted by counts in the thousands, preconditioned as
    ``solve_fista_batch`` does, at a lambda that prunes most of them."""
    w = torch.sort(torch.randn(B, M, generator=gen, device="cuda"),
                   dim=1).values
    if not weighted:
        d = torch.diff(w, dim=1, prepend=torch.zeros(B, 1, device="cuda"))
        n = torch.ones_like(w)
        eta = (1.0 / (power_iter_lipschitz(d, n) * 1.01)).float()
        return tuple(a.reshape(B, -1, 128) for a in (
            w, d, n, torch.full_like(w, 0.05))) + (eta.reshape(B, 1, 1),)
    w = w * 0.03
    d = torch.diff(w, dim=1, prepend=torch.zeros(B, 1, device="cuda"))
    n = torch.randint(1, 2000, (B, M), generator=gen, device="cuda").float()
    p = fista_batch_problem(w, d, n, 1.0)
    return (p["w"], p["d"], p["n"], p["lam"], p["eta"])


def _objective(args, alpha):
    """Eq. 6 per row in float64 on the kernel's (preconditioned) inputs."""
    B = alpha.shape[0]
    w, d, n, lam = (a.reshape(B, -1).double() for a in args[:4])
    a = alpha.reshape(B, -1).double()
    r = w - torch.cumsum(a * d, dim=1)
    return 0.5 * (n * r * r).sum(1) + (lam * a.abs()).sum(1)


@pytest.mark.parametrize("shape,n_iters", [("page", 100), ("ptq", 1000)])
def test_fista_kernel_matches_plain(gen, shape, n_iters):
    args = (_page_inputs if shape == "page" else _ptq_inputs)(gen)
    n0 = fista_quant.launches
    out = fista_quant(*args, n_iters=n_iters)
    assert fista_quant.launches == n0 + 1 and out.shape == args[0].shape
    B = out.shape[0]
    flat = [a.reshape(B, -1) for a in args[:4]]
    ref = ref_fista(*flat, args[4], n_iters=n_iters).reshape(out.shape)
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=1e-3)


def test_fista_kernel_reaches_the_plain_objective_on_weighted_rows(gen):
    args = _ptq_inputs(gen, weighted=True)
    out = fista_quant(*args, n_iters=1000)
    B = out.shape[0]
    ref = ref_fista(*[a.reshape(B, -1) for a in args[:4]], args[4],
                    n_iters=1000)
    fk, fr = _objective(args, out), _objective(args, ref)
    assert bool(((fk - fr).abs() <= 1e-3 * fr.abs()).all()), (fk, fr)
    exact = ref_fista(*[a.reshape(B, -1).double() for a in args[:4]],
                      args[4].double(), n_iters=1000)
    err_k = (out.reshape(B, -1) - exact).abs().max()
    err_p = (ref - exact).abs().max()
    assert err_k <= 3.0 * err_p, (err_k, err_p)


@pytest.mark.parametrize("shape", ["page", "ptq"])
def test_fista_row_alone_is_bitwise_the_row_in_the_batch(gen, shape):
    args = (_page_inputs if shape == "page" else _ptq_inputs)(gen)
    out = fista_quant(*args, n_iters=60)
    for i in (0, 3, args[0].shape[0] - 1):
        alone = fista_quant(*(a[i:i + 1].contiguous() for a in args),
                            n_iters=60)
        assert torch.equal(alone[0], out[i])


def test_fista_batch_padding_stays_zero(gen):
    """Rows of 60 and 90 values in one call: the zero-weight tail of the
    short row stays 0 and does not leak into its real columns (the
    reference's test_fista_batch_padding_mask, atol 1e-4)."""
    m1, m2 = 60, 90
    W = torch.zeros(2, m2, device="cuda")
    D, N = torch.zeros_like(W), torch.zeros_like(W)
    for i, m in enumerate((m1, m2)):
        v = torch.sort(torch.randn(m, generator=gen, device="cuda")).values
        W[i, :m] = v
        D[i, :m] = torch.diff(v, prepend=v.new_zeros(1))
        N[i, :m] = 1.0
    a2 = solve_fista_batch(W, D, N, 0.05, n_iters=200)
    a1 = solve_fista_batch(W[:1, :m1], D[:1, :m1], N[:1, :m1], 0.05,
                           n_iters=200)
    torch.testing.assert_close(a2[0, :m1], a1[0], atol=1e-4, rtol=0)
    assert bool((a2[0, m1:] == 0).all())


def test_quantize_pages_fista_row_alone_equals_the_row_among_224(gen):
    """Codes and codebook of a row solved alone equal that row's in a
    freeze of 224 rows, bitwise: every reduction over a row runs in a
    fixed order."""
    rows = torch.randn(224, 2048, generator=gen, device="cuda")
    rows[::5] *= 4.0
    n0 = fista_quant.launches
    codes, cb = quantize_pages_fista(rows, num_values=16)
    assert fista_quant.launches == n0 + 14          # one per bisection step
    assert int(codes.max()) < 16 and bool((cb.diff(dim=1) >= 0).all())
    for i in (0, 5, 117, 223):
        c1, cb1 = quantize_pages_fista(rows[i:i + 1], num_values=16)
        assert torch.equal(c1[0], codes[i]) and torch.equal(cb1[0], cb[i])


def test_quantize_pages_fista_never_waits_for_the_card(gen):
    """A freeze is one asynchronous dispatch on the side stream: nothing in
    it synchronizes the host with the card."""
    rows = torch.randn(56, 2048, generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        codes, cb = quantize_pages_fista(rows, num_values=16)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert codes.shape == rows.shape and cb.shape == (56, 16)


def test_fista_wrapper_rejects_what_the_kernel_does_not_take(gen):
    args = list(_page_inputs(gen, R=4))
    with pytest.raises(ValueError, match="f32"):
        fista_quant(*[a.double() for a in args])
    with pytest.raises(ValueError, match="contiguous"):
        w = torch.cat([args[0], args[0]], dim=1)[:, :1]   # strided view
        fista_quant(w, *args[1:])
    with pytest.raises(ValueError, match="at most 4096"):
        big = [torch.zeros(4, 33, 128, device="cuda")] * 4
        fista_quant(*big, args[4])
    with pytest.raises(ValueError, match="tensors on"):
        fista_quant(args[0], args[1].cpu(), *args[2:])
    with pytest.raises(ValueError, match="do not match"):
        fista_quant(args[0][:2], *args[1:])
