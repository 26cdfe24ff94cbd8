"""The hand-written CUDA kernels against their plain PyTorch versions, at
small shapes (paged attention at the reduced config's Dh 32, block 8).
Needs an NVIDIA GPU and nvcc: CUDA kernels have no interpret mode, so
without a card these tests skip. Run them on the card with ``python -m
pytest -q -m cuda tests/test_torch_cuda.py`` (this file imports no JAX).

Tolerance: paged attention atol 2e-5 / rtol 1e-4 at f32 (the reference's
kernel bar); quant_matmul and fista_quant below.
"""
import importlib

import pytest
import torch

from repro_torch.kernels import (pack4, paged_decode_attention,
                                 paged_prefill_attention, quant_matmul,
                                 quant_matmul_stacked, ref_paged_decode,
                                 ref_quant_matmul, ref_quant_matmul_stacked)
from repro_torch.core import QuantizedTensor
from repro_torch.kernels import (fista_quant, power_iter_lipschitz,
                                 quantize_pages_device, quantize_pages_fista,
                                 ref_fista, solve_fista_batch)
from repro_torch.kernels.ops import fista_batch_problem
from repro_torch.kernels.fista_quant import (fista_freeze, freeze_plain,
                                             start_vector)
from repro_torch.kernels.page_quant import (fista_page_problem,
                                            fista_page_refit,
                                            fista_page_sketch)
from repro_torch.kernels.quant_matmul import kernel_smem, plan
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


# The redesigned kernel's splits (64 keys a split, plan(bs, Dh, dtype)) at
# qwen3-0.6B's head shape (Dh 128, block 16, G = 2). Tolerances: f32 the
# reference's bar (above); bf16: kernel and plain version both compute in
# f32 and round the output once to bf16 (chip_smoke.py's BF16_TOL).
_PA_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
           torch.bfloat16: dict(atol=1e-5, rtol=2.0 ** -6)}
_SPLIT = 64


def _big_pool(gen, lens, dtype, *, Hkv=2, Dh=128, bs=16, L=16):
    """Pools for sequences of the given lengths (0 = an idle slot on the
    null page with valid 1), each on its own pages, half of them
    frozen."""
    pages = [-(-max(n, 1) // bs) for n in lens]
    nb = 1 + sum(p for p, n in zip(pages, lens) if n)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    k_fp, v_fp = rnd(nb, bs, Hkv, Dh).to(dtype), rnd(nb, bs, Hkv, Dh).to(dtype)
    codes = torch.randint(0, L, (2, nb, bs, Hkv, Dh), generator=gen,
                          device="cuda", dtype=torch.uint8)
    blk_q = torch.rand(nb, generator=gen, device="cuda") < 0.5
    blk_q[0] = False
    table = torch.zeros(len(lens), max(pages), dtype=torch.int32)
    nxt = 1
    for b, (p, n) in enumerate(zip(pages, lens)):
        if n:
            table[b, :p] = torch.arange(nxt, nxt + p)
            nxt += p
    state = [k_fp, v_fp, pack4(codes[0]), pack4(codes[1]), rnd(nb, L),
             rnd(nb, L), blk_q, table.cuda()]
    valid = torch.tensor([max(n, 1) for n in lens], dtype=torch.int32,
                         device="cuda")
    return state, valid


def _stale_nan(state, valid):
    """A copy of the pools with NaN in every fp row past each sequence's
    last key inside its last page (never read by the kernel; the plain
    version, which reads every table page, would turn them into NaN)."""
    k_fp, v_fp = state[0].clone(), state[1].clone()
    bs = k_fp.shape[1]
    for b, n in enumerate(valid.tolist()):
        last = int(state[-1][b, (n - 1) // bs])
        k_fp[last, (n - 1) % bs + 1:] = float("nan")
        v_fp[last, (n - 1) % bs + 1:] = float("nan")
    return [k_fp, v_fp, *state[2:]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_decode_kernel_at_split_boundaries(gen, dtype, softcap):
    """Valid lengths one short of, at, and one past 1, 2 and 8 splits, a
    2048-token sequence and an idle slot, one launch."""
    lens = [_SPLIT - 1, _SPLIT, _SPLIT + 1, 2 * _SPLIT - 1, 2 * _SPLIT + 1,
            8 * _SPLIT - 1, 8 * _SPLIT, 8 * _SPLIT + 1, 2048, 0]
    state, valid = _big_pool(gen, lens, dtype)
    q = torch.randn(len(lens), 4, 128, generator=gen, device="cuda").to(dtype)
    kw = dict(softcap=softcap, quantized=True, packed=True)
    ref = ref_paged_decode(q, *state, valid, **kw)
    out = paged_decode_attention(q, *_stale_nan(state, valid), valid, **kw)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), ref.float(), **_PA_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sequence_alone_is_bitwise_the_sequence_among_eight(gen, dtype):
    lens = [300, 17, 2048, 64, 0, 129, 511, 1000]
    state, valid = _big_pool(gen, lens, dtype)
    q = torch.randn(len(lens), 4, 128, generator=gen, device="cuda").to(dtype)
    out = paged_decode_attention(q, *state, valid, quantized=True)
    for b in range(len(lens)):
        alone = paged_decode_attention(
            q[b:b + 1], *state[:-1], state[-1][b:b + 1].clone(),
            valid[b:b + 1].clone(), quantized=True)
        assert torch.equal(alone[0], out[b])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_prefill_and_window_bitwise_across_splits(gen, dtype):
    """A 300-token prompt (5 splits) in chunks of 64 and of 7 equals the
    whole prompt; a W = 5 window at 700 tokens (11 splits, two rounds of
    the cluster) equals 5 single-row calls. Bitwise."""
    state, _ = _big_pool(gen, [300], dtype)
    q = torch.randn(1, 300, 4, 128, generator=gen, device="cuda").to(dtype)
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    whole = paged_prefill_attention(q, *state, zero, quantized=True)
    torch.testing.assert_close(whole.float(), ref_paged_decode(
        q, *state, zero + 300, quantized=True).float(), **_PA_TOL[dtype])
    for C in (64, 7):
        parts = torch.cat([paged_prefill_attention(
            q[:, o:o + C], *state, zero + o, quantized=True)
            for o in range(0, 300, C)], dim=1)
        assert torch.equal(whole, parts), C
    W = 5
    state, valid = _big_pool(gen, [700, 90, 6], dtype)
    qw = torch.randn(3, W, 4, 128, generator=gen, device="cuda").to(dtype)
    win = paged_decode_attention(qw, *state, valid, quantized=True)
    rows = torch.stack([paged_decode_attention(
        qw[:, w], *state, valid - (W - 1 - w), quantized=True)
        for w in range(W)], dim=1)
    assert torch.equal(win, rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_is_in_split_order_whatever_the_cluster(gen, dtype):
    """The splits are folded in split order, not by rank: clusters of 1, 3
    and 8 blocks (32, 11 and 4 rounds at 2048 tokens) give the plan's
    output bitwise."""
    pa = importlib.import_module("repro_torch.kernels.paged_attention")
    state, valid = _big_pool(gen, [2048, 700, 5], dtype)
    q = torch.randn(3, 6, 4, 128, generator=gen, device="cuda").to(dtype)
    kw = dict(softcap=None, quantized=True, packed=True)
    want = pa._launch(q, *state, valid, **kw)
    base = pa.plan(16, 128, dtype)
    for cluster in (1, 3, 8):
        got = pa._launch(q, *state, valid, **kw,
                         pl=base._replace(cluster=cluster))
        assert torch.equal(got, want), cluster


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [1, 4, 8, 32])
def test_decode_kernel_at_other_block_sizes(gen, dtype, bs):
    """Pages of 1-32 keys (several pages a warp, or a page over two warps),
    packed and unpacked codes, Dh 64."""
    for packed, L in ((True, 16), (False, 200)):
        lens = [130, 1, 64 + bs, 0]
        pages = [-(-max(n, 1) // bs) for n in lens]
        nb = 1 + sum(pages)
        rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
        codes = torch.randint(0, L, (2, nb, bs, 2, 64), generator=gen,
                              device="cuda", dtype=torch.uint8)
        if packed:
            codes = pack4(codes)
        blk_q = torch.rand(nb, generator=gen, device="cuda") < 0.5
        table = torch.zeros(len(lens), max(pages), dtype=torch.int32)
        nxt = 1
        for b, p in enumerate(pages):
            table[b, :p] = torch.arange(nxt, nxt + p)
            nxt += p
        state = [rnd(nb, bs, 2, 64).to(dtype), rnd(nb, bs, 2, 64).to(dtype),
                 codes[0].contiguous(), codes[1].contiguous(), rnd(nb, L),
                 rnd(nb, L), blk_q, table.cuda()]
        valid = torch.tensor([max(n, 1) for n in lens], dtype=torch.int32,
                             device="cuda")
        q = torch.randn(len(lens), 3, 6, 64, generator=gen,
                        device="cuda").to(dtype)
        kw = dict(quantized=True, packed=packed)
        torch.testing.assert_close(
            paged_decode_attention(q, *state, valid, **kw).float(),
            ref_paged_decode(q, *state, valid, **kw).float(),
            **_PA_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_shared_memory_fits_every_plan(gen, dtype):
    """The block the kernel lays out fits Hopper's 227 KB for every block
    size, head_dim and codebook width the wrapper takes; at the main
    path's shape (bs 16, Dh 128, L 16, bf16) four blocks fit an SM's 228
    KB, 1 KB each reserved."""
    pa = importlib.import_module("repro_torch.kernels.paged_attention")
    for bs in (1, 2, 4, 8, 16, 32):
        for Dh in (32, 64, 96, 128):
            for L in (1, 16, 256):
                smem = pa.kernel_smem(pa.plan(bs, Dh, dtype), bs, Dh, L,
                                      dtype)
                assert 0 < smem <= 232448, (bs, Dh, L)
    main = pa.kernel_smem(pa.plan(16, 128, torch.bfloat16), 16, 128, 16,
                          torch.bfloat16)
    assert 4 * (main + 1024) <= 233472


def test_paged_attention_wrapper_rejects_what_the_kernel_does_not_take(gen):
    pa = importlib.import_module("repro_torch.kernels.paged_attention")
    state = _pool(gen)
    table = torch.tensor([[1, 2]], dtype=torch.int32, device="cuda")
    valid = torch.tensor([9], dtype=torch.int32, device="cuda")
    q = torch.randn(1, 4, 32, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="q dtype"):
        paged_decode_attention(q.half(), *state, table, valid, quantized=True)
    with pytest.raises(ValueError, match="k_fp/v_fp"):
        paged_decode_attention(q.to(torch.bfloat16), *state, table, valid,
                               quantized=True)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.tensor([[1, 0, 2, 0]], dtype=torch.int32,
                               device="cuda")[:, ::2]
        paged_decode_attention(q, *state, strided, valid, quantized=True)
    with pytest.raises(ValueError, match="head_dim"):
        paged_decode_attention(q[..., :16], *[t[..., :16] for t in state[:2]],
                               *state[2:], table, valid)
    with pytest.raises(ValueError, match="codes shape"):
        paged_decode_attention(q, *state[:2], state[2][..., :8], *state[3:],
                               table, valid, quantized=True)
    with pytest.raises(ValueError, match="block size"):
        big = [torch.zeros(2, 48, 2, 32, device="cuda")] * 2
        paged_decode_attention(q, *big, *state[2:], table, valid)
    with pytest.raises(RuntimeError, match="launch failed"):
        pl = pa.plan(8, 32, torch.float32)          # 64 keys a split
        pa._launch(q[:, None], *state, table, valid, softcap=None,
                   quantized=True, packed=True,
                   pl=pl._replace(split_pages=4))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", [(3072, 1024), (1000, 1024)])
def test_quant_matmul_rows_are_bitwise_independent_of_m_under_split_k(
        gen, K, N, dtype):
    """The plan splits K over a cluster (here 8 splits; K = 1000 ends the
    last split inside its last step): rows of an M=128 call (two row tiles)
    equal the same rows at M = 1, 4 and 64 at any offset, bitwise."""
    pl = plan(K, N, 16, dtype, torch.uint8)
    assert pl.splits > 1
    x, idx, cb = _qmm_inputs(gen, 128, K, N, dtype=dtype)
    full = quant_matmul(x, idx, cb)          # two 64-row tiles
    torch.testing.assert_close(full.float(),
                               ref_quant_matmul(x, idx, cb).float(),
                               **_QMM_TOL[dtype])
    for m in (1, 4, 64):
        for r0 in (0, 13, 64 - m, 64):
            assert torch.equal(quant_matmul(x[r0:r0 + m], idx, cb),
                               full[r0:r0 + m])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_stacked_groups_are_the_flat_kernel_under_split_k(
        gen, dtype):
    G, M, K, N = 3, 4, 1024, 1024
    assert plan(K, N, 16, dtype, torch.uint8).splits == 8
    x, idx, cb = _qmm_inputs(gen, M, K, N, G=G, dtype=dtype)
    out = quant_matmul_stacked(x, idx, cb)
    torch.testing.assert_close(
        out.float(), ref_quant_matmul_stacked(x, idx, cb).float(),
        **_QMM_TOL[dtype])
    for g in range(G):
        assert torch.equal(out[g], quant_matmul(x[g], idx[g], cb[g]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("idx_dtype,bad", [(torch.uint8, 200),
                                           (torch.int32, -1),
                                           (torch.int32, 1 << 20)])
def test_quant_matmul_out_of_range_code_is_nan_in_its_column(
        gen, dtype, idx_dtype, bad):
    """A code outside [0, L) reads as NaN (the reference's jnp.take fill):
    every row of its column is NaN, every other output finite."""
    M, K, N = 4, 1000, 1024
    x, idx, cb = _qmm_inputs(gen, M, K, N, dtype=dtype, idx_dtype=idx_dtype)
    idx[517, 300] = bad
    out = quant_matmul(x, idx, cb)
    assert bool(torch.isnan(out[:, 300]).all())
    rest = torch.cat([out[:, :300], out[:, 301:]], dim=1)
    assert bool(torch.isfinite(rest).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1000, 33])
def test_quant_matmul_terms_past_k_are_exactly_zero(gen, K, dtype):
    """Codebook entry 0 is inf and no code uses it: the ragged last step's
    positions past K (whose codes the kernel zero-fills) must add nothing,
    not 0 * inf."""
    x, idx, cb = _qmm_inputs(gen, 4, K, 256, dtype=dtype)
    idx = idx.clamp(min=1)
    cb[0] = float("inf")
    out = quant_matmul(x, idx, cb)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(),
                               ref_quant_matmul(x, idx, cb).float(),
                               **_QMM_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(16, 1024, 1024), (4, 2048, 1024),
                                   (5, 33, 17)])
def test_quant_matmul_codebook_of_32768_entries(gen, M, K, N, dtype):
    """L = 32768 with int32 codes: the largest codebook the kernel stages
    (64 KB in bf16, 128 KB in f32) beside its ring, clusters of up to 8
    such blocks."""
    x, idx, cb = _qmm_inputs(gen, M, K, N, L=32768, dtype=dtype,
                             idx_dtype=torch.int32)
    n0 = quant_matmul.launches
    out = quant_matmul(x, idx, cb)
    assert quant_matmul.launches == n0 + 1
    torch.testing.assert_close(out.float(),
                               ref_quant_matmul(x, idx, cb).float(),
                               **_QMM_TOL[dtype])


@pytest.mark.parametrize("L,x_dtype,idx_dtype", [
    (L, x, i) for L in (16, 1000, 32768)
    for x in (torch.bfloat16, torch.float32)
    for i in (torch.uint8, torch.int32)
    if i == torch.int32 or L <= 256])       # uint8 codes address 256
def test_kernel_shared_memory_fits_every_plan(gen, L, x_dtype,
                                              idx_dtype):
    """The block the kernel lays out for any weight's plan fits Hopper's
    227 KB, up to L = 32768; at the main path's L = 16 (bf16, uint8 codes)
    four blocks fit an SM's 228 KB, 1 KB each reserved."""
    for K, N in [(1024, 1024), (1024, 2048), (1024, 3072), (2048, 1024),
                 (3072, 1024), (33, 17), (64, 64), (8192, 8192)]:
        pl = plan(K, N, L, x_dtype, idx_dtype)
        stages, smem = kernel_smem(pl, L, x_dtype, idx_dtype)
        assert stages == min(2, pl.split_steps)
        assert smem <= 232448
        if (L, x_dtype, idx_dtype) == (16, torch.bfloat16, torch.uint8):
            assert 4 * (smem + 1024) <= 233472


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
    n0, f0 = fista_quant.launches, fista_freeze.launches
    codes, cb = quantize_pages_fista(rows, num_values=16)
    # the whole solve is one launch of the freeze entry
    assert (fista_quant.launches, fista_freeze.launches) == (n0, f0 + 1)
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


def test_quantize_pages_device_never_waits_for_the_card(gen):
    """The kmeans_ls freeze (the main path's) is one asynchronous dispatch
    too: its DP fills unreachable cells with a scalar, not a tensor copied
    from the host."""
    rows = torch.randn(56, 2048, generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        codes, cb = quantize_pages_device(rows, num_values=16)
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


def _freeze_rows(gen, R=224, E=2048):
    rows = torch.randn(R, E, generator=gen, device="cuda")
    rows[::5] *= 4.0
    rows[1::7] *= torch.linspace(0.1, 3.0, E, device="cuda")
    return rows


@pytest.mark.parametrize("E,L", [(2048, 16), (100, 64)])
def test_fista_freeze_is_the_composed_freeze_bitwise(gen, E, L):
    """One launch of the freeze entry == the torch composition with
    BISECT_STEPS launches of fista_quant, bitwise: best, eta, lam_hi, and
    the codes and codebooks refit from them. E = 100: the sketch has 28
    padding columns, which stay in the support (as in the reference), so
    a budget of 64 levels."""
    rows = _freeze_rows(gen, E=E)
    sk = fista_page_sketch(rows)
    args = (sk["w"], sk["d"], sk["n"], start_vector(128, "cuda"))
    n0, f0 = fista_quant.launches, fista_freeze.launches
    fused = fista_freeze(*args, num_values=L)
    assert fista_freeze.launches == f0 + 1 and fista_quant.launches == n0
    plain = freeze_plain(*args, num_values=L)
    assert fista_quant.launches == n0 + 14
    for a, b in zip(fused, plain):
        assert a.shape == b.shape and torch.equal(a, b)
    assert int((fused[0].abs() > 1e-12).sum()) > 0
    for a, b in zip(fista_page_refit(rows, sk, fused[0], L),
                    fista_page_refit(rows, sk, plain[0], L)):
        assert torch.equal(a, b)


def test_fista_freeze_power_iteration_is_fista_page_problem_bitwise(gen):
    """The launch's eta (40 power iterations) and lam_hi equal
    fista_page_problem's torch ops on the card, bitwise."""
    rows = _freeze_rows(gen)
    p = fista_page_problem(rows)
    _, eta, lam_hi = fista_freeze(p["w"], p["d"], p["n"],
                                  start_vector(128, "cuda"), num_values=16)
    assert torch.equal(eta, p["eta"]) and torch.equal(lam_hi, p["lam_hi"])


def test_fista_freeze_row_alone_is_the_row_among_224(gen):
    rows = _freeze_rows(gen)
    sk = fista_page_sketch(rows)
    x0 = start_vector(128, "cuda")
    out = fista_freeze(sk["w"], sk["d"], sk["n"], x0, num_values=16)
    for i in (0, 5, 117, 223):
        one = fista_freeze(*(sk[k][i:i + 1] for k in "wdn"), x0,
                           num_values=16)
        for a, b in zip(one, out):
            assert torch.equal(a[0], b[i])


def _reference_rows(gen, B, M):
    """The reference kernel test's inputs (sorted normal rows, unit
    weights, lambda 0.05, the power-iteration step size) as (B, 1, M)."""
    w = torch.sort(torch.randn(B, M, generator=gen, device="cuda"),
                   dim=1).values
    d = torch.diff(w, dim=1, prepend=torch.zeros(B, 1, device="cuda"))
    n = torch.ones_like(w)
    eta = (1.0 / (power_iter_lipschitz(d, n) * 1.01)).float()
    return tuple(a.reshape(B, 1, M) for a in (
        w, d, n, torch.full_like(w, 0.05))) + (eta.reshape(B, 1, 1),)


@pytest.mark.parametrize("M", [1, 5, 100, 127, 128, 129, 255, 300, 1000,
                               2048, 4000, 4096])
def test_fista_kernel_bar_at_every_width(gen, M):
    """The reference's bar (atol 2e-4 / rtol 1e-3) at widths 1-4096, one
    warp a row up to 128 columns and a block of a warp per 128 columns
    past it."""
    args = _reference_rows(gen, 3, M)
    out = fista_quant(*args, n_iters=300)
    ref = ref_fista(*[a.reshape(3, M) for a in args[:4]], args[4],
                    n_iters=300).reshape(out.shape)
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=1e-3)


def test_fista_freeze_wrapper_rejects_what_the_kernel_does_not_take(gen):
    sk = fista_page_sketch(_freeze_rows(gen, R=4))
    w, d, n = sk["w"], sk["d"], sk["n"]
    x0 = start_vector(128, "cuda")
    with pytest.raises(ValueError, match="f32"):
        fista_freeze(w.double(), d, n, x0, num_values=16)
    with pytest.raises(ValueError, match="do not match"):
        fista_freeze(w[:, :64].contiguous(), d, n, x0, num_values=16)
    with pytest.raises(ValueError, match="contiguous"):
        fista_freeze(torch.cat([w, w], 1)[:, ::2], d, n, x0, num_values=16)
    with pytest.raises(ValueError, match="tensors on"):
        fista_freeze(w, d, n, x0.cpu(), num_values=16)
    with pytest.raises(ValueError, match="num_values"):
        fista_freeze(w, d, n, x0, num_values=0)
