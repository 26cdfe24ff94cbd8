"""The hand-written CUDA kernels against their plain PyTorch versions, at
small shapes (paged attention at the reduced config's Dh 32, block 8), and
the serving paths that feed them on the card (page migration, frozen
payloads solved on a side stream, overload restores).
Needs an NVIDIA GPU and nvcc: CUDA kernels have no interpret mode, so
without a card these tests skip. Run them on the card with ``python -m
pytest -q -m cuda tests/test_torch_cuda.py`` (this file imports no JAX).

Tolerance: paged attention atol 2e-5 / rtol 1e-4 at f32 (the reference's
kernel bar); quant_matmul and fista_quant below.
"""
import dataclasses
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


def _shape_pool(gen, lens, dtype, *, Dh, bs, Hkv=2, L=16, packed=True):
    """Pools of any head_dim and block size (half the pages frozen) for
    sequences of the given lengths, each on its own pages; returns the
    kernel's arguments after q and the valid lengths."""
    pages = [-(-max(n, 1) // bs) for n in lens]
    nb = 1 + sum(pages)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    codes = torch.randint(0, L, (2, nb, bs, Hkv, Dh), generator=gen,
                          device="cuda", dtype=torch.uint8)
    if packed:
        codes = pack4(codes)
    blk_q = torch.rand(nb, generator=gen, device="cuda") < 0.5
    blk_q[0] = False
    table = torch.zeros(len(lens), max(pages), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(pages):
        table[b, :n] = torch.arange(nxt, nxt + n)
        nxt += n
    state = [rnd(nb, bs, Hkv, Dh).to(dtype), rnd(nb, bs, Hkv, Dh).to(dtype),
             codes[0].clone(), codes[1].clone(), rnd(nb, L), rnd(nb, L),
             blk_q, table.cuda()]
    valid = torch.tensor([max(n, 1) for n in lens], dtype=torch.int32,
                         device="cuda")
    return state, valid


# every head_dim and block size the reference kernel takes (Dh 1-256, even
# when packed; bs 1-128), sampled: each Dh and each bs at least once, with
# fp, packed and unpacked pools, decode, a W = 4 window and prefill chunks
_SHAPES = [(1, 1, "fp"), (8, 5, "packed"), (8, 64, "unpacked"),
           (16, 8, "packed"), (24, 12, "packed"), (24, 3, "unpacked"),
           (40, 16, "fp"), (64, 24, "packed"), (80, 32, "unpacked"),
           (100, 48, "packed"), (128, 128, "packed"), (130, 7, "fp"),
           (192, 16, "packed"), (200, 100, "unpacked"), (255, 2, "fp"),
           (256, 64, "packed"), (256, 1, "unpacked")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh,bs,pool", _SHAPES)
def test_kernel_at_every_head_dim_and_block_size(gen, dtype, Dh, bs, pool):
    """Decode (ragged lengths over split boundaries, an idle slot), a W = 4
    window and two prefill chunks against the plain version, at the
    reference's bar (f32) or a bf16 ulp (bf16); non-finite values in the
    pool rows past each length never reach the output."""
    L = 200 if pool == "unpacked" else 16
    lens = [1, 63, 64, 65, 130, 300, 0]
    state, valid = _shape_pool(gen, lens, dtype, Dh=Dh, bs=bs, L=L,
                               packed=pool == "packed")
    kw = dict(quantized=pool != "fp", packed=pool == "packed")
    for W in (1, 4):
        q = torch.randn(len(lens), W, 6, Dh, generator=gen,
                        device="cuda").to(dtype)
        qq = q if W > 1 else q[:, 0]
        for softcap in (None, 30.0):
            out = paged_decode_attention(qq, *_stale_nan(state, valid),
                                         valid, softcap=softcap, **kw)
            ref = ref_paged_decode(qq, *state, valid, softcap=softcap, **kw)
            assert bool(torch.isfinite(out).all())
            torch.testing.assert_close(out.float(), ref.float(),
                                       **_PA_TOL[dtype])
    state, _ = _shape_pool(gen, [300], dtype, Dh=Dh, bs=bs, L=L,
                           packed=pool == "packed")
    q = torch.randn(1, 100, 6, Dh, generator=gen, device="cuda").to(dtype)
    for off in (0, 200):
        o = torch.tensor([off], dtype=torch.int32, device="cuda")
        torch.testing.assert_close(
            paged_prefill_attention(q, *state, o, **kw).float(),
            ref_paged_decode(q, *state, o + 100, **kw).float(),
            **_PA_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh,bs", [(24, 12), (8, 64)])
def test_bitwise_invariants_at_padded_head_dims_and_odd_blocks(
        gen, dtype, Dh, bs):
    """At a padded head_dim and a block that does not divide the 64-key
    split (Dh 24, bs 12) and at Dh 8 with 64-key pages: chunked prefill
    (chunks of 64 and 7) equals the whole prompt, a W = 5 window equals 5
    single rows, and clusters of 1, 3 and 8 fold the same bits."""
    pa = importlib.import_module("repro_torch.kernels.paged_attention")
    kw = dict(quantized=True, packed=True)
    state, _ = _shape_pool(gen, [300], dtype, Dh=Dh, bs=bs)
    q = torch.randn(1, 300, 8, Dh, generator=gen, device="cuda").to(dtype)
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    whole = paged_prefill_attention(q, *state, zero, **kw)
    torch.testing.assert_close(whole.float(), ref_paged_decode(
        q, *state, zero + 300, **kw).float(), **_PA_TOL[dtype])
    for C in (64, 7):
        parts = torch.cat([paged_prefill_attention(
            q[:, o:o + C], *state, zero + o, **kw)
            for o in range(0, 300, C)], dim=1)
        assert torch.equal(whole, parts), C
    W = 5
    state, valid = _shape_pool(gen, [700, 90, 6], dtype, Dh=Dh, bs=bs)
    qw = torch.randn(3, W, 8, Dh, generator=gen, device="cuda").to(dtype)
    win = paged_decode_attention(qw, *state, valid, **kw)
    rows = torch.stack([paged_decode_attention(
        qw[:, w], *state, valid - (W - 1 - w), **kw)
        for w in range(W)], dim=1)
    assert torch.equal(win, rows)
    base = pa.plan(bs, Dh, dtype)
    for cluster in (1, 3, 8):
        got = pa._launch(qw, *state, valid, softcap=None, **kw,
                         pl=base._replace(cluster=cluster))
        assert torch.equal(got, win), cluster


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_shared_memory_fits_every_plan(gen, dtype):
    """The block the kernel lays out fits Hopper's 227 KB for every block
    size, head_dim and codebook width the wrapper takes; at the main
    path's shape (bs 16, Dh 128, L 16, bf16) four blocks fit an SM's 228
    KB, 1 KB each reserved."""
    pa = importlib.import_module("repro_torch.kernels.paged_attention")
    for bs in (1, 2, 3, 5, 8, 12, 16, 24, 32, 48, 64, 100, 128):
        for Dh in (1, 8, 24, 32, 64, 96, 128, 130, 192, 256):
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
        wide = [torch.zeros(9, 8, 2, 257, device="cuda")] * 2
        paged_decode_attention(torch.zeros(1, 4, 257, device="cuda"), *wide,
                               *state[2:], table, valid)
    with pytest.raises(ValueError, match="codes shape"):
        paged_decode_attention(q, *state[:2], state[2][..., :8], *state[3:],
                               table, valid, quantized=True)
    with pytest.raises(ValueError, match="block size"):
        big = [torch.zeros(2, 129, 2, 32, device="cuda")] * 2
        paged_decode_attention(q, *big, *state[2:], table, valid)
    with pytest.raises(RuntimeError, match="launch failed"):
        pl = pa.plan(8, 32, torch.float32)          # 64 keys a split
        pa._launch(q[:, None], *state, table, valid, softcap=None,
                   quantized=True, packed=True,
                   pl=pl._replace(split_keys=32))


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


def test_quantize_pages_fista_options_on_the_card(gen):
    """quantize_pages_fista(n_iters=50, bisect_steps=10, lloyd_rounds=2):
    one launch of the freeze entry and no host sync; from the card's
    solved support, the refit and its two Lloyd rounds on the card equal
    the CPU's (codes equal, codebooks within 1e-5: the kmeans freeze's
    bar), and the whole freeze's rows stay within one level of the CPU
    run's."""
    from repro_torch.kernels.fista_quant import nnz_of

    rows = _freeze_rows(gen, R=32)
    kw = dict(num_values=16, n_iters=50, bisect_steps=10, lloyd_rounds=2)
    torch.cuda.synchronize()
    n0, f0 = fista_quant.launches, fista_freeze.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        codes, cb = quantize_pages_fista(rows, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (fista_quant.launches, fista_freeze.launches) == (n0, f0 + 1)
    assert int(codes.max()) < 16 and bool((cb.diff(dim=1) >= 0).all())
    sk = fista_page_sketch(rows)
    best = fista_freeze(sk["w"], sk["d"], sk["n"], start_vector(128, "cuda"),
                        num_values=16, n_iters=50, bisect_steps=10)[0]
    c_card, cb_card = fista_page_refit(rows, sk, best, 16, lloyd_rounds=2)
    assert torch.equal(c_card, codes) and torch.equal(cb_card, cb)
    sk_cpu = {k: v.cpu() for k, v in sk.items()}
    c_cpu, cb_cpu = fista_page_refit(rows.cpu(), sk_cpu, best.cpu(), 16,
                                     lloyd_rounds=2)
    assert torch.equal(c_card.cpu(), c_cpu)
    torch.testing.assert_close(cb_card.cpu(), cb_cpu, atol=1e-5, rtol=0)
    _, cb0 = fista_page_refit(rows, sk, best, 16)
    assert not torch.equal(cb0, cb)          # the rounds moved codebooks
    cpu = quantize_pages_fista(rows.cpu(), **kw)
    assert cpu[0].shape == codes.shape
    lv_cpu = freeze_plain(*(sk_cpu[k] for k in "wdn"), start_vector(128, "cpu"),
                          num_values=16, n_iters=50, bisect_steps=10)[0]
    gap = (nnz_of(best)[0].cpu() - nnz_of(lv_cpu)[0]).abs().max()
    assert int(gap) <= 1


@pytest.mark.parametrize("spec", ["l1:lam=2.0", "l1_ls:lam=2.0",
                                  "l1l2:lam=2.0", "tv:lam=2.0",
                                  "tv_iter@16", "dp@16"])
def test_host_solvers_on_card_tensors_equal_the_cpu(gen, spec):
    """A host solve of card tensors gives the CPU's values: the problem is
    built on the card, solved on the host, refit on the card. l1's
    reconstruction is a cumsum: on the card's parallel scan, positions
    with one prefix could round apart and split a shared value."""
    from repro_torch.core import quantize

    w = torch.rand(500, generator=gen, device="cuda") * 100
    qt, info = quantize(w, spec)
    qt_c, info_c = quantize(w.cpu(), spec)
    assert qt.codebook.is_cuda and info["n_values"] == info_c["n_values"]
    torch.testing.assert_close(qt.to_dense().cpu(), qt_c.to_dense(),
                               atol=1e-5, rtol=1e-6)


def _fista_rows(gen, B=3, M=1000):
    w = torch.sort(torch.randn(B, M, generator=gen, device="cuda"),
                   dim=1).values
    d = torch.diff(w, dim=1, prepend=torch.zeros(B, 1, device="cuda"))
    return w, d, torch.ones_like(w)


@pytest.mark.parametrize("opts", [dict(penalize_first=False),
                                  dict(precondition=False)])
def test_solve_fista_batch_options_against_the_plain_version(gen, opts):
    """Each option of solve_fista_batch: one kernel launch, against
    use_kernel=False (the plain version, no launch) on the card: the
    objective within 1e-3 and the distance from a float64 run at most 3x
    the plain version's (the bounds of the PTQ rows above)."""
    w, d, n = _fista_rows(gen)
    n0 = fista_quant.launches
    got = solve_fista_batch(w, d, n, 0.05, n_iters=500, **opts)
    assert fista_quant.launches == n0 + 1
    ref = solve_fista_batch(w, d, n, 0.05, n_iters=500, use_kernel=False,
                            **opts)
    assert fista_quant.launches == n0 + 1
    p = fista_batch_problem(w, d, n, 0.05, **opts)
    B, M = w.shape
    exact = ref_fista(*(p[k].reshape(B, -1)[:, :M].double()
                        for k in ("w", "d", "n", "lam")), p["eta"].double(),
                      n_iters=500) / p["scale"].double()
    lam = torch.full_like(w, 0.05, dtype=torch.float64)
    if not opts.get("penalize_first", True):
        lam[:, 0] = 0.0

    def f(a):
        a = a.double()
        r = w.double() - torch.cumsum(a * d.double(), dim=1)
        return 0.5 * (r * r).sum(1) + (lam * a.abs()).sum(1)
    assert bool(((f(got) - f(ref)).abs() <= 1e-3 * f(ref).abs()).all())
    assert (got - exact).abs().max() <= 3.0 * (ref - exact).abs().max()


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


# ------------------------------------------------ serving paths on the card
# The reduced qwen3 config (4 layers, Dh 32, f32) served on the card, block
# 8: the kernel serves the verify window (W = k + 1) and prefills that start
# past spliced frozen pages.


def _reduced_model(gen, ptq: bool = False):
    from repro_torch import models
    from repro_torch.configs import get_reduced_config

    cfg = get_reduced_config("qwen3_0_6b")
    params = models.init_params(cfg, gen, "cuda")
    if ptq:
        from repro_torch.launch.serve import PTQ_SKIP
        from repro_torch.quant import quantize_tree
        params, _ = quantize_tree(params, "kmeans_ls@16",
                                  skip_patterns=PTQ_SKIP)
    return cfg, params


def _draft(params, cfg, which, gen):
    """The half-depth draft, or one with its own random weights and an
    untied random head (it disagrees at almost every position, so verify
    windows roll back)."""
    import dataclasses

    from repro_torch import models
    from repro_torch.serving import derive_draft

    if which == "auto":
        return derive_draft(params, cfg)
    dcfg = dataclasses.replace(cfg, tie_embeddings=False)
    return models.init_params(dcfg, gen.manual_seed(99), "cuda"), dcfg


@pytest.mark.parametrize("which", ["auto", "random"])
def test_fused_spec_engine_tokens_equal_non_speculative(gen, which):
    """The fused speculative engine (verify windows of 4 through the
    kernel, the draft on the gather path) gives the non-speculative fused
    engine's greedy tokens on an fp pool, request logits within 1e-3 (the
    reference's engine bar); the half-depth draft is accepted, the random
    one rolled back; every target call launches the kernel once per
    layer."""
    from repro_torch.serving import ContinuousBatchingEngine

    cfg, params = _reduced_model(gen)
    rng = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=rng).tolist()
               for n in (12, 19, 8)]
    runs = []
    for k in (0, 3):
        eng = ContinuousBatchingEngine(
            params, cfg, device="cuda", max_slots=2, block_size=8,
            max_seq_len=48, attn_impl="fused", record_logits=True,
            speculate=k, draft=_draft(params, cfg, which, gen) if k else None)
        n0 = paged_decode_attention.launches
        out = eng.generate(prompts, max_new_tokens=10)
        launches = paged_decode_attention.launches - n0
        assert launches == cfg.n_layers * eng.counters["decode_steps"]
        runs.append((eng, out))
    (base, out_b), (spec, out_s) = runs
    assert out_s == out_b
    for i in range(len(prompts)):
        torch.testing.assert_close(
            torch.from_numpy(spec.request_logits[i]),
            torch.from_numpy(base.request_logits[i]), atol=1e-3, rtol=0)
    s = spec.metrics.summary()
    if which == "auto":
        tps = (s["gen_tokens"] - s["completed"]) / spec.counters[
            "seq_decode_steps"]
        assert s["spec_accepted"] > 0 and tps > 1
        assert spec.counters["decode_steps"] < base.counters["decode_steps"]
    else:
        assert s["spec_rollbacks"] > s["completed"]


def test_rollback_never_freezes_past_watermark_on_the_card(gen):
    """A random draft forcing rollbacks through the fused verify window,
    on a kmeans_ls@16 pool whose freezes run on the side stream (1 page a
    step, block 4, so windows cross pages): after every step no page is
    frozen, queued or kept by an in-flight solve past its slot's accepted
    seq_lens, and the pool drains."""
    from repro_torch.serving import ContinuousBatchingEngine

    cfg, params = _reduced_model(gen)
    eng = ContinuousBatchingEngine(
        params, cfg, device="cuda", max_slots=2, block_size=4,
        max_seq_len=64, kv_quant="kmeans_ls@16", freeze_page_budget=1,
        attn_impl="fused", speculate=3,
        draft=_draft(params, cfg, "random", gen))
    w = eng.worker
    step, bad = w.step, []

    def checked_step(now_fn):
        step(now_fn)
        bad.extend(w.frozen_past_watermark())

    w.step = checked_step
    rng = torch.Generator().manual_seed(6)
    prompts = [torch.randint(0, cfg.vocab, (9,), generator=rng).tolist()
               for _ in range(3)]
    out = eng.generate(prompts, max_new_tokens=10)
    assert not bad, bad
    s = eng.metrics.summary()
    assert s["spec_rollbacks"] > s["completed"]
    assert w.counters["freeze_installs"] > 0
    assert all(len(v) == 10 for v in out.values())
    assert w.alloc.num_free == w.num_blocks - 1


def test_fused_prefill_past_spliced_frozen_pages_is_the_whole_prefill(gen):
    """A prompt's last 16 tokens prefilled through the kernel past 3
    spliced frozen pages (PTQ'd weights, so every projection's rows are
    the kernel's, independent of the row count) write the same K/V rows,
    bitwise, as a whole-prompt prefill over a table that starts with the
    same frozen pages; their logits rows agree within 1e-5 (the lm_head
    is a torch.matmul, whose bits may depend on its row count)."""
    from repro_torch import models
    from repro_torch.serving.kv_cache import (freeze_blocks,
                                              init_paged_cache,
                                              with_prefill_fused,
                                              with_tables)

    cfg, params = _reduced_model(gen, ptq=True)
    bs, P, shared = 8, 40, 3
    pool = init_paged_cache(cfg, num_blocks=10, block_size=bs,
                            quantized=True, fused=True, device="cuda")
    rng = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (1, P), generator=rng)
    pos = torch.arange(P, dtype=torch.int32)[None]

    def prefill(table, off):
        views = with_prefill_fused(with_tables(
            pool, torch.tensor([table], dtype=torch.int32).numpy(),
            torch.tensor([off], dtype=torch.int32).numpy()))
        logits, _ = models.prefill(
            params, cfg, {"tokens": toks[:, off:].cuda(),
                          "positions": pos[:, off:].cuda()}, views)
        return logits

    prefill([1, 2, 3, 4, 5], 0)             # the sharer's prompt
    freeze_blocks(pool, [1, 2, 3], "kmeans_ls@16")
    n0 = paged_decode_attention.launches
    part = prefill([1, 2, 3, 4, 5], shared * bs)     # spliced, then past
    assert paged_decode_attention.launches - n0 == cfg.n_layers
    whole = prefill([1, 2, 3, 6, 7], 0)     # pages 1-3 frozen: codes serve
    for name in ("k_fp", "v_fp"):
        t = getattr(pool, name)
        assert torch.equal(t[:, 4:6], t[:, 6:8]), name
    torch.testing.assert_close(part[0], whole[0, shared * bs:], atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------- the reduced configs on the card
# glm4 and yi (Dh 8; G = 4), gemma2 (Dh 16; window 8 on its local layers,
# which read by gather, softcaps on its global ones through the kernel),
# all f32, block 12 (a page straddling the kernel's 16-key warp chunks).


@pytest.mark.parametrize("arch,block_size", [
    ("glm4_9b", 12), ("yi_34b", 12), ("gemma2_27b", 12), ("glm4_9b", 1),
    ("glm4_9b", 5), ("glm4_9b", 7)])
def test_fused_engine_equals_gather_engine_on_the_reduced_configs(
        gen, arch, block_size):
    """A fused engine (kernel 1 for every decode step and prefill chunk of
    a full-context layer) against a gather engine on the same kmeans_ls@16
    pages: equal greedy tokens, request logits within 1e-3 (the
    reference's fused-vs-gather engine bar); the kernel launched once per
    full-context layer per step and chunk. At blocks 1, 5 and 7 one
    layer's packed code pages of reduced glm4 (4-byte rows) are not a
    whole number of 16-byte pieces, over an odd page count: every layer
    past the first must still be served."""
    from repro_torch import models
    from repro_torch.configs import get_reduced_config
    from repro_torch.serving import ContinuousBatchingEngine

    cfg = get_reduced_config(arch)
    params = models.init_params(cfg, gen, "cuda")
    full = sum(1 for s in cfg.layer_specs() if s.window is None)
    rng = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=rng).tolist()
               for n in (20, 13, 31)]
    runs = []
    for impl in ("fused", "gather"):
        eng = ContinuousBatchingEngine(
            params, cfg, device="cuda", max_slots=2, block_size=block_size,
            max_seq_len=48, attn_impl=impl, record_logits=True,
            kv_quant="kmeans_ls@16", freeze_async=False, prefill_chunk=7)
        n0 = paged_decode_attention.launches
        out = eng.generate(prompts, max_new_tokens=10)
        launches = paged_decode_attention.launches - n0
        steps = (eng.counters["decode_steps"]
                 + eng.prefill.counters["prefill_chunks"])
        assert launches == (full * steps if impl == "fused" else 0)
        assert eng.counters["freeze_installs"] > 0
        runs.append((eng, out))
    (fused, out_f), (gather, out_g) = runs
    assert out_f == out_g
    for i in range(len(prompts)):
        torch.testing.assert_close(
            torch.from_numpy(fused.request_logits[i]),
            torch.from_numpy(gather.request_logits[i]), atol=1e-3, rtol=0)


@pytest.mark.parametrize("kv_quant", [None, "kmeans_ls@16"])
def test_fused_granite_engine_equals_gather_engine(gen, kv_quant):
    """The reduced granite (attention + MoE, Hq 4 over Hkv 2, Dh 16) on
    the continuous engine with whole-prompt prefills, fused against
    gather, on fp and on kmeans_ls@16 pages: equal greedy tokens, request
    logits within 1e-3 (the engine bar); the kernel launched once per
    layer per decode step, and never by a whole-prompt prefill."""
    from repro_torch import models
    from repro_torch.configs import get_reduced_config
    from repro_torch.serving import ContinuousBatchingEngine

    cfg = get_reduced_config("granite_moe_3b_a800m")
    params = models.init_params(cfg, gen, "cuda")
    rng = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=rng).tolist()
               for n in (20, 13, 31)]
    runs = []
    for impl in ("fused", "gather"):
        eng = ContinuousBatchingEngine(
            params, cfg, device="cuda", max_slots=2, block_size=8,
            max_seq_len=48, attn_impl=impl, record_logits=True,
            kv_quant=kv_quant, freeze_async=False)
        n0 = paged_decode_attention.launches
        out = eng.generate(prompts, max_new_tokens=10)
        launches = paged_decode_attention.launches - n0
        assert eng.prefill.counters["prefill_chunks"] == 0
        assert launches == (cfg.n_layers * eng.counters["decode_steps"]
                            if impl == "fused" else 0)
        assert (eng.counters["freeze_installs"] > 0) == bool(kv_quant)
        runs.append((eng, out))
    (fused, out_f), (gather, out_g) = runs
    assert out_f == out_g
    for i in range(len(prompts)):
        torch.testing.assert_close(
            torch.from_numpy(fused.request_logits[i]),
            torch.from_numpy(gather.request_logits[i]), atol=1e-3, rtol=0)


@pytest.mark.parametrize("method", ["dp", "tv_iter"])
def test_host_freeze_of_card_pages_equals_the_cpu(gen, method):
    """The per-page host freeze of a card pool gives the codes and
    codebooks of the same pool on the CPU, bitwise (both solve the same
    host values), counting one solve per (page, layer, k/v) row."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.serving import dispatch_freeze, init_paged_cache

    cfg = get_reduced_config("glm4_9b")
    pools = [init_paged_cache(cfg, num_blocks=6, block_size=12,
                              quantized=True, num_values=16, device=d)
             for d in ("cuda", "cpu")]
    k = torch.randn(pools[0].k_fp.shape, generator=gen, device="cuda")
    v = torch.randn(pools[0].v_fp.shape, generator=gen, device="cuda")
    for pool in pools:
        pool.k_fp.copy_(k)
        pool.v_fp.copy_(v)
    card, cpu = (dispatch_freeze(p, [4, 2, 5], f"{method}@16") for p in pools)
    assert card.codes.is_cuda and card.is_ready()
    assert card.host_solves == cpu.host_solves == 3 * cfg.n_layers * 2
    assert torch.equal(card.codes.cpu(), cpu.codes)
    assert torch.equal(card.cb.cpu(), cpu.cb)


# ------------------------------------------- fp page migration on the card
# A prefill pool (fp) and a decode pool (kmeans_ls@16, packed) of other
# sizes: their layers start at different padded strides, so only a splice
# by block id in each layer's view lands the pages where a decode reads
# them.


@pytest.mark.parametrize("arch,block_size", [
    ("glm4_9b", 1), ("glm4_9b", 5), ("glm4_9b", 7), ("glm4_9b", 16),
    ("qwen3_0_6b", 16)])
def test_fp_transfer_is_bitwise_between_pools_of_other_strides(
        gen, arch, block_size):
    """extract -> to_host -> splice between pools of different padded
    strides: landed pages and tail rows equal the source bitwise, the
    destination's other pages (and the tail page's other rows, codes,
    codebooks and flags) untouched, and the kernel's decode over the
    landed pages equals its decode over the source pages bitwise."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.serving import (extract_pages, init_paged_cache,
                                     splice_payload)

    cfg = get_reduced_config(arch)
    bs = block_size
    mb = -(-64 // bs)
    src = init_paged_cache(cfg, num_blocks=2 * mb + 1, block_size=bs,
                           device="cuda")
    dst = init_paged_cache(cfg, num_blocks=2 * mb + 2, block_size=bs,
                           quantized=True, num_values=16, device="cuda")
    assert src.k_fp.stride(0) != dst.k_fp.stride(0)
    for pool in (src, dst):
        for t in (pool.k_fp, pool.v_fp):
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    dst.k_codes.random_(0, 256, generator=gen)
    dst.blk_q[::3] = True
    P = 3 * bs + max(bs // 2, 1) if bs > 1 else 7
    n_full, r = divmod(P, bs)
    n_pages = n_full + (1 if r else 0)
    blocks = list(range(src.k_fp.shape[1] - 1, 0, -1))[:n_pages]
    new = [b for b in range(1, dst.k_fp.shape[1]) if b % 3][:n_pages]
    before = {n: getattr(dst, n).clone() for n in
              ("k_fp", "v_fp", "k_codes", "k_cb", "blk_q")}
    payload = extract_pages(src, blocks, P, block_size=bs, mode="fp")
    torch.cuda.synchronize()
    assert payload.event is not None and payload.is_ready()
    payload.to_host()
    assert payload.full is None or not payload.full.is_cuda
    assert payload.nbytes == payload.fp_equiv_bytes
    splice_payload(dst, payload, new)
    for name in ("k_fp", "v_fp"):
        s, d, d0 = getattr(src, name), getattr(dst, name), before[name]
        for j in range(n_full):
            assert torch.equal(d[:, new[j]], s[:, blocks[j]])
        if r:
            assert torch.equal(d[:, new[n_full], :r],
                               s[:, blocks[n_full], :r])
            assert torch.equal(d[:, new[n_full], r:], d0[:, new[n_full], r:])
        rest = [b for b in range(d.shape[1]) if b not in new]
        assert torch.equal(d[:, rest], d0[:, rest])
    for name in ("k_codes", "k_cb", "blk_q"):
        assert torch.equal(getattr(dst, name), before[name])
    q = torch.randn(1, cfg.n_heads, cfg.head_dim, generator=gen,
                    device="cuda")
    valid = torch.tensor([P], dtype=torch.int32, device="cuda")

    def decode(pool, table):
        bt = torch.tensor([table], dtype=torch.int32, device="cuda")
        return [paged_decode_attention(
            q, pool.k_fp[i], pool.v_fp[i], pool.k_codes[i], pool.v_codes[i],
            pool.k_cb[i], pool.v_cb[i], pool.blk_q, bt, valid,
            quantized=False) for i in range(cfg.n_layers)]
    n0 = paged_decode_attention.launches
    for a, b in zip(decode(src, blocks), decode(dst, new)):
        assert torch.equal(a, b)
    assert paged_decode_attention.launches - n0 == 2 * cfg.n_layers


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "glm4_9b"])
def test_disagg_engine_equals_colocated_on_the_card(gen, arch):
    """The fused disaggregated engine (fp pages migrating from the prefill
    worker's pool) against the fused colocated engine on an fp pool, f32:
    equal greedy tokens, logits within 1e-4 of their range; the kernel
    launched once a layer a decode step (the owned pool's whole-prompt
    prefills read by gather), and every handoff counted."""
    from repro_torch import models
    from repro_torch.configs import get_reduced_config
    from repro_torch.serving import ContinuousBatchingEngine, DisaggEngine

    cfg = get_reduced_config(arch)
    params = models.init_params(cfg, gen, "cuda")
    rng = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=rng).tolist()
               for n in (20, 13, 31)]
    kw = dict(device="cuda", max_slots=2, block_size=8, max_seq_len=48,
              attn_impl="fused", record_logits=True)
    co = ContinuousBatchingEngine(params, cfg, **kw)
    out_co = co.generate(prompts, max_new_tokens=10)
    dz = DisaggEngine(params, cfg, **kw)
    n0 = paged_decode_attention.launches
    out_dz = dz.generate(prompts, max_new_tokens=10)
    assert paged_decode_attention.launches - n0 == (
        cfg.n_layers * dz.counters["decode_steps"])
    assert out_dz == out_co
    scale = max(float(abs(co.request_logits[i]).max())
                for i in range(len(prompts)))
    for i in range(len(prompts)):
        d = float(abs(dz.request_logits[i] - co.request_logits[i]).max())
        assert d <= 1e-4 * scale, (i, d, scale)
    c = dz.counters
    assert c["migrated_seqs"] == len(prompts)
    assert c["migrate_bytes"] == c["migrate_fp_equiv_bytes"] > 0
    assert dz.decode[0].alloc.num_free == dz.decode[0].num_blocks - 1


# ------------------------------- frozen migration and overload on the card
# A frozen payload's codes come from the source pool's side stream: its
# readiness must cover the solve, and staging must wait for it. Restores
# land on the main stream ahead of the decode step that reads them.


def _reduced_quantized_pool(gen, cfg, num_blocks, bs):
    from repro_torch.serving import init_paged_cache

    pool = init_paged_cache(cfg, num_blocks=num_blocks, block_size=bs,
                            quantized=True, num_values=16, device="cuda")
    for t in (pool.k_fp, pool.v_fp):
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    return pool


@pytest.mark.parametrize("spec", ["kmeans_ls@16", "iter_l1@16"])
def test_frozen_payload_staged_at_is_ready_holds_the_synchronous_solve(
        gen, spec):
    """extract(frozen) enqueues the solve on the pool's side stream; once
    is_ready() turns true the staged codes and codebooks equal those a
    synchronous freeze of the same pages installs, bitwise (iter_l1: one
    fista_freeze launch for the payload's solve)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels import fista_freeze
    from repro_torch.serving import extract_pages, freeze_blocks

    cfg = get_reduced_config("qwen3_0_6b")
    bs, P = 8, 45
    src = _reduced_quantized_pool(gen, cfg, 13, bs)
    sync = dataclasses.replace(src, **{n: getattr(src, n).clone() for n in (
        "k_fp", "v_fp", "k_codes", "v_codes", "k_cb", "v_cb", "blk_q")},
        _stream=None)
    blocks = [9, 2, 11, 4, 7, 1]
    n_full = P // bs
    n0 = fista_freeze.launches
    payload = extract_pages(src, blocks, P, block_size=bs, mode="frozen",
                            spec=spec)
    assert payload.solve_event is not None
    if spec.startswith("iter_l1"):
        assert fista_freeze.launches - n0 == 1
    while not payload.is_ready():
        pass
    payload.to_host()
    codes, cb = payload.frozen
    assert not codes.is_cuda and payload.solve_event is None
    freeze_blocks(sync, blocks[:n_full], spec)
    for r, j in enumerate(payload.frozen_idx):
        b = blocks[j]
        assert torch.equal(codes[0, :, r], sync.k_codes[:, b].cpu())
        assert torch.equal(codes[1, :, r], sync.v_codes[:, b].cpu())
        assert torch.equal(cb[0, :, r], sync.k_cb[:, b].cpu())
        assert torch.equal(cb[1, :, r], sync.v_cb[:, b].cpu())
    assert torch.equal(payload.tail[0], src.k_fp[:, blocks[n_full],
                                                 :P % bs].cpu())


def test_resident_payload_lands_bitwise_between_pools_of_other_strides(gen):
    """A live sequence's pages, half installed-frozen, demoted
    (extract_resident_pages -> to_host) and restored into a pool of
    another stride: codes, codebooks, reconstructions, flags, fp pages and
    tail rows bitwise, and the kernel reads the same attention from
    both."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.serving import (extract_resident_pages, freeze_blocks,
                                     splice_payload)

    cfg = get_reduced_config("qwen3_0_6b")
    bs, P = 8, 45
    src = _reduced_quantized_pool(gen, cfg, 13, bs)
    dst = _reduced_quantized_pool(gen, cfg, 29, bs)
    assert src.k_fp.stride(0) != dst.k_fp.stride(0)
    blocks = [9, 2, 11, 4, 7, 1]
    n_full = P // bs
    frozen_idx = [0, 1, 3]
    freeze_blocks(src, [blocks[j] for j in frozen_idx], "kmeans_ls@16")
    new = [20, 3, 17, 8, 25, 12]
    payload = extract_resident_pages(src, blocks, P, frozen_idx,
                                     block_size=bs)
    payload.to_host()
    splice_payload(dst, payload, new)
    for j in range(n_full):
        names = (("k_fp", "v_fp", "k_codes", "v_codes", "k_cb", "v_cb")
                 if j in frozen_idx else ("k_fp", "v_fp"))
        for name in names:
            assert torch.equal(getattr(dst, name)[:, new[j]],
                               getattr(src, name)[:, blocks[j]]), (name, j)
        assert bool(dst.blk_q[new[j]]) == (j in frozen_idx)
    r = P % bs
    assert torch.equal(dst.k_fp[:, new[n_full], :r],
                       src.k_fp[:, blocks[n_full], :r])
    q = torch.randn(1, cfg.n_heads, cfg.head_dim, generator=gen,
                    device="cuda")
    valid = torch.tensor([P], dtype=torch.int32, device="cuda")

    def decode(pool, table):
        bt = torch.tensor([table], dtype=torch.int32, device="cuda")
        return [paged_decode_attention(
            q, pool.k_fp[i], pool.v_fp[i], pool.k_codes[i], pool.v_codes[i],
            pool.k_cb[i], pool.v_cb[i], pool.blk_q, bt, valid,
            quantized=True, packed=True) for i in range(cfg.n_layers)]
    for a, b in zip(decode(src, blocks), decode(dst, new)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("speculate", [0, 2])
def test_fused_forced_restore_tokens_equal_the_uninterrupted_run(gen,
                                                                 speculate):
    """Reduced qwen3, fused kernel, kmeans_ls@16, synchronous freezes: the
    longest sequence demoted at decode steps 3 and 7 and restored at once
    gives the uninterrupted run's greedy tokens, and its logits within
    1e-5 of their range (the decode batch keeps its shape, so a row's bits
    depend on nothing the restore changes)."""
    from repro_torch import models
    from repro_torch.configs import get_reduced_config
    from repro_torch.serving import (ContinuousBatchingEngine, Request,
                                     derive_draft)

    cfg = get_reduced_config("qwen3_0_6b")
    params = models.init_params(cfg, gen, "cuda")
    rng = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, cfg.vocab, (12,), generator=rng).tolist()
               for _ in range(3)]
    reqs = lambda: [Request(id=i, prompt=tuple(p), max_new_tokens=12)
                    for i, p in enumerate(prompts)]
    kw = dict(device="cuda", max_slots=2, block_size=8, max_seq_len=48,
              kv_quant="kmeans_ls@16", freeze_async=False,
              attn_impl="fused", record_logits=True, speculate=speculate,
              draft=derive_draft(params, cfg) if speculate else None)
    golden = ContinuousBatchingEngine(params, cfg, **kw)
    golden.run(reqs())
    eng = ContinuousBatchingEngine(params, cfg, offload_pages=True, **kw)
    om, w = eng.overload, eng.worker
    orig_step, fired = w.step, set()

    def step(now_fn):
        n = w.counters["decode_steps"]
        if n in (3, 7) and n not in fired and w.sched.active:
            fired.add(n)
            slot = max(w.sched.active, key=lambda i: (int(w.lens[i]), i))
            st = w.sched.active[slot]
            if not st.done and w.slots[slot].out:
                entry = w.preempt(st, "restore", now_fn())
                om.store.put(entry)
                om.resume.append(entry)
        orig_step(now_fn)

    w.step = step
    s = eng.run(reqs())
    assert fired and s["preempt_offloads"] == s["restored_seqs"] >= 1
    assert s["offload_bytes"] == s["restore_bytes"] > 0
    assert dict(eng.outputs) == dict(golden.outputs)
    scale = max(float(abs(golden.request_logits[i]).max()) for i in range(3))
    for i in range(3):
        d = float(abs(eng.request_logits[i] - golden.request_logits[i]).max())
        assert d <= 1e-5 * scale, (i, d, scale)


def test_frozen_migrated_pages_read_through_the_kernel_match_gather(gen):
    """disagg with frozen migration on the card: the fused engine (kernel
    1 reading the landed codes) gives the gather engine's greedy tokens
    and logits within 1e-3; every handoff crossed as codes + codebooks,
    and the kernel launched once a layer a decode step."""
    from repro_torch import models
    from repro_torch.configs import get_reduced_config
    from repro_torch.serving import DisaggEngine, page_bytes

    cfg = get_reduced_config("qwen3_0_6b")
    params = models.init_params(cfg, gen, "cuda")
    rng = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=rng).tolist()
               for n in (20, 16, 31)]
    runs = {}
    for impl in ("gather", "fused"):
        eng = DisaggEngine(params, cfg, device="cuda", migrate="frozen",
                           max_slots=2, block_size=8, max_seq_len=48,
                           kv_quant="kmeans_ls@16", record_logits=True,
                           attn_impl=impl, freeze_async=False,
                           block_prefill=True)
        n0 = paged_decode_attention.launches
        out = eng.generate(prompts, max_new_tokens=8)
        runs[impl] = (eng, out, paged_decode_attention.launches - n0)
    (g, g_out, g_n), (f, f_out, f_n) = runs["gather"], runs["fused"]
    assert g_n == 0 and f_n == cfg.n_layers * f.counters["decode_steps"]
    assert f_out == g_out
    for i in range(len(prompts)):
        d = abs(f.request_logits[i] - g.request_logits[i]).max()
        assert float(d) <= 1e-3, (i, float(d))
    c = f.counters
    pb = page_bytes(cfg, 8, quantized=True, num_values=16)
    n_full = sum(n // 8 for n in (20, 16, 31))
    tails = sum(n % 8 for n in (20, 16, 31))
    row = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 4
    assert c["migrate_bytes"] == n_full * pb["frozen"] + tails * row
    assert f._summary()["migrate_solves"] == len(prompts)


def test_tracing_adds_no_host_sync_on_the_card(gen):
    """Tracing and the metrics exporter read host state only: under
    ``torch.cuda.set_sync_debug_mode("warn")`` a traced and exported
    ``generate()`` of the reduced engine on the card (fused kernel,
    kmeans_ls@16 pages, chunked prefill) raises exactly as many
    synchronizing-call warnings as an untraced one, and gives the same
    tokens. Freezes are synchronous: with asynchronous ones the end-of-run
    drain waits on each solve still in flight, and how many are depends
    on the card's timing, not on tracing."""
    import warnings

    from repro_torch import models
    from repro_torch.configs import get_reduced_config
    from repro_torch.obs import MetricsExporter, Tracer, count_events
    from repro_torch.serving import ContinuousBatchingEngine

    cfg = get_reduced_config("qwen3_0_6b")
    params = models.init_params(cfg, gen, "cuda")
    rng = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=rng).tolist()
               for n in (20, 16, 31)]

    def run(tracer=None, exporter=None):
        eng = ContinuousBatchingEngine(
            params, cfg, device="cuda", max_slots=2, block_size=8,
            max_seq_len=64, kv_quant="kmeans_ls@16", attn_impl="fused",
            freeze_async=False, prefill_chunk=5, tracer=tracer,
            exporter=exporter)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = eng.generate(prompts, max_new_tokens=12)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        return syncs, out, eng

    run()                       # first calls: builds, allocator growth
    n_plain, out_plain, _ = run()
    tr, exp = Tracer(), MetricsExporter(None, interval_s=0.0)
    n_traced, out_traced, eng = run(tr, exp)
    assert n_plain > 0
    assert n_traced == n_plain
    assert out_traced == out_plain
    assert count_events(tr.events, name="decode_step", ph="X") \
        == eng.counters["decode_steps"]
    assert count_events(tr.events, name="roofline", ph="C") > 0
    assert eng.metrics.stats.gauge("hbm_bytes_per_token").n > 0
    assert len(exp.lines) > 2


def test_bf16_train_step_on_the_card(gen):
    """One train step of the reduced qwen3 in bf16 (params, activations
    and grads; f32 AdamW state) on the card: finite loss and grad norm,
    every param moved, bf16 params and f32 moments kept, and no kernel
    launched (training reaches none)."""
    from repro_torch import models
    from repro_torch.configs import get_reduced_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.fista_quant import fista_freeze
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import items

    cfg = dataclasses.replace(get_reduced_config("qwen3_0_6b"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = models.init_params(cfg, gen, "cuda")
    step, opt = make_train_step(cfg, lr=1e-2)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    pipe = SyntheticLM(cfg, 2, 1024)
    kernels = (paged_decode_attention, quant_matmul, quant_matmul_stacked,
               fista_quant, fista_freeze)
    for k in kernels:
        k.launches = 0
    new, m = step(state, pipe.next_batch(0, pipe.batch_specs(), "cuda"))
    assert all(torch.isfinite(m[k]) for k in ("loss", "grad_norm"))
    assert int(new["step"]) == 1
    for (k, a), (_, b) in zip(items(new["params"]), items(params)):
        assert a.dtype == torch.bfloat16 and not torch.equal(a, b), k
    assert {str(t.dtype) for _, t in items(new["opt"]["m"])} == {
        "torch.float32"}
    assert [k.launches for k in kernels] == [0] * len(kernels)
