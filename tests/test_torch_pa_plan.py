"""The paged-attention kernel's launch plan (``repro_torch.kernels.
paged_attention.plan``) and its merge rule, on the CPU: the kernel's row
independence rests on a plan that never sees B, W, G, the valid lengths or
the table width, cuts keys at fixed key multiples, and on a fold in which
a fully masked partial is an exact identity. The kernel itself, and the
shared memory it lays out for a plan, run only on the card
(tests/test_torch_cuda.py)."""
import importlib
import inspect

import pytest
import torch

from repro_torch.kernels import BIG_NEG, pack4

# the module (the package's ``paged_decode_attention`` attribute is the
# function)
pa = importlib.import_module("repro_torch.kernels.paged_attention")
plan = pa.plan

torch.set_num_threads(1)

BLOCK_SIZES = [1, 2, 4, 5, 8, 12, 16, 24, 32, 48, 64, 100, 128]
DTYPES = [torch.bfloat16, torch.float32]


def test_plan_takes_no_batch_window_group_length_or_table_width():
    assert list(inspect.signature(plan).parameters) == ["bs", "Dh", "dtype"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_splits_sit_at_page_multiples_and_cover_every_length(bs, dtype):
    """For every valid length 1..2048 the splits cover the sequence's keys
    exactly once, in order, each starting at a multiple of
    pa.SPLIT_KEYS keys and holding that many (the last may hold fewer),
    whatever the block size: a page that does not divide the split (or is
    longer than it) straddles splits, each key at (key // bs, key % bs);
    every page of the sequence is read by some split."""
    for Dh in (1, 8, 24, 32, 64, 128, 256):
        pl = plan(bs, Dh, dtype)
        assert pl == plan(16, 128, torch.bfloat16)
        assert pl.split_keys == pa.SPLIT_KEYS
        assert pl.tile_rows == pa.TILE_ROWS and 1 <= pl.cluster <= 8
    S = pl.split_keys
    for valid in range(1, 2049):
        ranges = pl.split_ranges(valid)
        assert len(ranges) == -(-valid // S)
        covered = [k for a, b in ranges for k in range(a, b)]
        assert covered == list(range(valid))
        assert all(a == s * S and b - a <= S
                   for s, (a, b) in enumerate(ranges))
        pages = {k // bs for a, b in ranges for k in range(a, b)}
        assert pages == set(range(-(-valid // bs)))


def test_decode_shape_fills_the_card():
    """A decode step of 4 sequences x 272 tokens at qwen3-0.6B's (Hq 16,
    Hkv 8, Dh 128, bs 16) runs at least 132 working blocks (one per split,
    tile, kv head and sequence) on the H100's 132 SMs."""
    B, Hq, Hkv, Dh, bs, valid = 4, 16, 8, 128, 16, 272
    pl = plan(bs, Dh, torch.bfloat16)
    rows = 1 * Hq // Hkv                        # W * G
    n_splits = len(pl.split_ranges(valid))
    tiles = -(-rows // pl.tile_rows)
    working = n_splits * tiles * Hkv * B
    assert working >= 132
    assert pl.blocks(B, rows, Hkv) == tiles * pl.cluster * Hkv * B >= working


def _record_launch(monkeypatch):
    """Replace the kernel and the stream with recorders, so ``_launch``
    runs on CPU tensors and returns the arguments it would pass."""
    calls = []
    monkeypatch.setattr(pa, "_lib", lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(pa, "_stream", lambda dev: 0)
    monkeypatch.setattr(pa.paged_decode_attention, "launches",
                        pa.paged_decode_attention.launches)
    return calls


def _pool(gen, *, nb=5, bs=16, Hkv=2, Dh=64, L=16, packed=True,
          dtype=torch.bfloat16):
    codes = torch.randint(0, L, (2, nb, bs, Hkv, Dh), generator=gen,
                          dtype=torch.uint8)
    if packed:
        codes = pack4(codes)
    return [torch.randn(nb, bs, Hkv, Dh, generator=gen).to(dtype),
            torch.randn(nb, bs, Hkv, Dh, generator=gen).to(dtype),
            codes[0].contiguous(), codes[1].contiguous(),
            torch.randn(nb, L, generator=gen),
            torch.randn(nb, L, generator=gen),
            torch.zeros(nb, dtype=torch.bool)]


# the launch arguments after the pointers, sizes and scales: quantized,
# packed, then the plan's split_keys, tile_rows, cluster; then the dtype
_PLAN_ARGS = slice(25, 28)


@pytest.mark.parametrize("bs,Dh", [(16, 128), (8, 32), (32, 64), (12, 24),
                                   (64, 8)])
def test_wrapper_passes_the_plan_whatever_softcap_packing_b_w(
        monkeypatch, bs, Dh):
    """The kernel gets plan(bs, Dh, dtype): the same for every softcap,
    packed or unpacked codes, batch, window and valid length."""
    calls = _record_launch(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    for packed in (True, False):
        state = _pool(gen, bs=bs, Dh=Dh, packed=packed)
        for B, W, valid in ((1, 1, 1), (3, 4, 40), (2, 64, 80)):
            q = torch.randn(B, W, 4, Dh, generator=gen).to(torch.bfloat16)
            table = torch.ones(B, 5, dtype=torch.int32)
            lens = torch.full((B,), valid, dtype=torch.int32)
            for softcap in (None, 30.0):
                pa._launch(q, *state, table, lens, softcap=softcap,
                           quantized=True, packed=packed)
    want = tuple(plan(bs, Dh, torch.bfloat16))
    assert len(calls) == 2 * 3 * 2
    assert all(c[_PLAN_ARGS] == want for c in calls)
    assert {c[24] for c in calls} == {0, 1}          # packed was passed


def test_wrapper_reads_the_plan_of_bs_dh_and_dtype_alone(monkeypatch):
    """The wrapper asks the plan with the pool's block size, head_dim and
    q's dtype, and with nothing else, whatever B, W and the lengths."""
    calls = _record_launch(monkeypatch)
    asked = []
    monkeypatch.setattr(pa, "plan", lambda *a, **k: asked.append((a, k))
                        or plan(*a, **k))
    gen = torch.Generator().manual_seed(1)
    state = _pool(gen, bs=8, Dh=32)
    for B, W, valid in ((1, 1, 3), (4, 7, 39)):
        q = torch.randn(B, W, 4, 32, generator=gen).to(torch.bfloat16)
        pa._launch(q, *state, torch.ones(B, 5, dtype=torch.int32),
                   torch.full((B,), valid, dtype=torch.int32), softcap=None,
                   quantized=True, packed=True)
    assert asked == [((8, 32, torch.bfloat16), {})] * 2
    assert len(calls) == 2


# ------------------------------------------------------------ merge rule


def _merge(state, part):
    """The kernel's fold of two softmax partials (m, l, acc) of the same
    rows (``merge_step`` and ``apply`` in csrc/paged_attention.cu), in
    plain f32 torch: m, l (...,), acc (..., Dh). A partial with l = 0 (no
    live key) is the identity; into an empty state (l = 0) the partial is
    copied; otherwise both are rescaled to the larger max."""
    M, L, A = state
    m, l, a = part
    mn = torch.maximum(M, m)
    c0, c1 = torch.exp(M - mn), torch.exp(m - mn)
    live, first = l != 0, L == 0
    M2 = torch.where(first, m, mn)
    L2 = torch.where(first, l, L * c0 + l * c1)
    A2 = torch.where(first[..., None], a, A * c0[..., None]
                     + a * c1[..., None])
    return (torch.where(live, M2, M), torch.where(live, L2, L),
            torch.where(live[..., None], A2, A))


def _partial(gen, rows=6, Dh=16):
    m = torch.randn(rows, generator=gen) * 10
    l = torch.rand(rows, generator=gen) * 50 + 1
    a = torch.randn(rows, Dh, generator=gen) * 30
    return m, l, a


def _empty(rows=6, Dh=16):
    return (torch.full((rows,), BIG_NEG), torch.zeros(rows),
            torch.zeros(rows, Dh))


def _bits_equal(x, y):
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(x, y))


@pytest.mark.parametrize("seed", range(5))
def test_masked_partial_merges_as_an_exact_identity(seed):
    """Merging an all-masked partial (BIG_NEG, 0, 0) into any finite
    partial, on either side, returns that partial bitwise."""
    gen = torch.Generator().manual_seed(seed)
    part = _partial(gen)
    assert _bits_equal(_merge(part, _empty()), part)
    assert _bits_equal(_merge(_empty(), part), part)
    # the kernel's fold starts from the empty state: a row whose later
    # splits are all masked has the bits of its live splits' fold
    folded = _merge(_merge(_empty(), part),
                               _partial(gen))
    assert _bits_equal(_merge(folded, _empty()), folded)


def test_fold_of_split_partials_is_the_softmax():
    """Per-split partials of random scores, folded in split order with
    masked splits interleaved, give softmax(s) @ v (f32, 1e-6)."""
    gen = torch.Generator().manual_seed(0)
    rows, keys, Dh = 5, 200, 16
    s = torch.randn(rows, keys, generator=gen, dtype=torch.float64) * 4
    v = torch.randn(keys, Dh, generator=gen, dtype=torch.float64)
    want = (torch.softmax(s, dim=1) @ v).float()
    state = _empty(rows, Dh)
    for k0 in range(0, keys, 64):
        ss, vv = s[:, k0:k0 + 64].float(), v[k0:k0 + 64].float()
        m = ss.max(dim=1).values
        p = torch.exp(ss - m[:, None])
        state = _merge(state, (m, p.sum(1), p @ vv))
        state = _merge(state, _empty(rows, Dh))
    out = state[2] / state[1][:, None]
    torch.testing.assert_close(out, want, atol=1e-6, rtol=1e-5)
