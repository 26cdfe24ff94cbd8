"""Page migration (``repro_torch.serving.transfer``: fp, frozen and
resident payloads) held to the reference's ``repro.serving.transfer`` on
the same pages, and to itself across pools of different sizes.

A prefill pool (fp, ``2 * max_prompt_blocks + 1`` pages) and a decode pool
(kmeans_ls@16, ``max_slots * max_blocks + 1`` pages) pad their layer
strides differently (``kv_cache._pool_tensors``), so a splice that indexed
by flat offset would land pages in the wrong layer. Reduced qwen3 at
blocks 8 and 16 and reduced glm4 (Dh 8) at blocks 1, 5 and 7 (its code
pages are not whole 16-byte pieces there, so the decode pool is padded).

Tolerance: none. Landed pages, tail rows and the untouched rest are
bitwise; the payload's tensors equal the reference's bitwise (both copy
the same f32 values), but for a frozen payload's solved codebooks: its
codes are bitwise the reference's, its codebooks within atol 1e-6 (the
refit means' f32 sums, ``tests/test_torch_page_quant.py``'s bar); a
decode over landed pages equals one over the
source pages bitwise; frozen pages land as an in-place freeze of the same
pages would leave them, codes, codebooks and reconstruction bitwise.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced_config
from repro.serving import extract_pages as jax_extract_pages
from repro.serving import extract_resident_pages as jax_extract_resident
from repro.serving import init_paged_cache as jax_init_paged_cache
from repro.serving.kv_cache import resolve_kv_spec as jax_resolve_kv_spec
from repro.serving.transfer import collect_leaves
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import paged_decode_attention
from repro_torch.serving import (FinishedPrefill, PagePayload,
                                 extract_pages, extract_resident_pages,
                                 freeze_blocks, init_paged_cache,
                                 splice_payload)
from repro_torch.serving.transfer import MODES, check_mode, splice_of

# tiny tensors: one intra-op thread (more make these shapes far slower)
torch.set_num_threads(1)

pytestmark = pytest.mark.serving

# (arch, block size, prompt tokens): every case has full pages and a tail
CASES = [("qwen3_0_6b", 8, 20), ("qwen3_0_6b", 16, 37), ("glm4_9b", 1, 3),
         ("glm4_9b", 5, 13), ("glm4_9b", 7, 16)]


def _pools(arch, bs, seed=0):
    """A filled fp prefill pool and a filled kmeans_ls@16 decode pool of
    another size (random values everywhere, some decode pages frozen)."""
    cfg = get_reduced_config(arch)
    max_blocks = -(-48 // bs)
    src = init_paged_cache(cfg, num_blocks=2 * max_blocks + 1,
                           block_size=bs, device="cpu")
    dst = init_paged_cache(cfg, num_blocks=2 * max_blocks + 3,
                           block_size=bs, quantized=True, num_values=16,
                           device="cpu")
    g = torch.Generator().manual_seed(seed)
    for pool in (src, dst):
        for name in ("k_fp", "v_fp"):
            t = getattr(pool, name)
            t.copy_(torch.randn(t.shape, generator=g))
    for name in ("k_codes", "v_codes"):
        t = getattr(dst, name)
        t.copy_(torch.randint(0, 256, t.shape, generator=g,
                              dtype=torch.uint8))
    dst.blk_q[::3] = True
    return cfg, src, dst


def _snapshot(pool):
    return {n: getattr(pool, n).clone() for n in
            ("k_fp", "v_fp", "k_codes", "v_codes", "k_cb", "v_cb", "blk_q")}


@pytest.mark.parametrize("arch,bs,P", CASES)
def test_fp_migration_lands_pages_bitwise_between_pools_of_other_strides(
        arch, bs, P):
    cfg, src, dst = _pools(arch, bs)
    assert src.k_fp.stride(0) != dst.k_fp.stride(0)
    n_pages = -(-P // bs)
    n_full, r = divmod(P, bs)
    # out-of-order source ids; destination ids interleaved with frozen
    # pages (which must stay frozen and untouched)
    blocks = list(range(src.k_fp.shape[1] - 1, 0, -1))[:n_pages]
    new = [b for b in range(1, dst.k_fp.shape[1]) if b % 3][:n_pages]
    before = _snapshot(dst)
    payload = extract_pages(src, blocks, P, block_size=bs, mode="fp")
    assert payload.is_ready() and not payload.staged
    payload.to_host()
    itemsize = src.k_fp.element_size()
    assert payload.nbytes == payload.fp_equiv_bytes == (
        2 * cfg.n_layers * P * cfg.n_kv_heads * cfg.head_dim * itemsize)
    assert (payload.n_full, payload.tail_rows, payload.n_pages) == (
        n_full, r, n_pages)
    splice_payload(dst, payload, new)
    for name in ("k_fp", "v_fp"):
        s, d, d0 = getattr(src, name), getattr(dst, name), before[name]
        for j in range(n_full):
            assert torch.equal(d[:, new[j]], s[:, blocks[j]]), (name, j)
        if r:
            t = new[n_full]
            assert torch.equal(d[:, t, :r], s[:, blocks[n_full], :r])
            # the rest of the tail page stays as it was
            assert torch.equal(d[:, t, r:], d0[:, t, r:])
        rest = [b for b in range(d.shape[1]) if b not in new[:n_pages]]
        assert torch.equal(d[:, rest], d0[:, rest]), name
    for name in ("k_codes", "v_codes", "k_cb", "v_cb", "blk_q"):
        assert torch.equal(getattr(dst, name), before[name]), name
    # a decode over the landed pages reads what one over the source reads
    q = torch.randn(1, cfg.n_heads, cfg.head_dim,
                    generator=torch.Generator().manual_seed(1))
    valid = torch.tensor([P], dtype=torch.int32)

    def decode(pool, table):
        bt = torch.tensor([table], dtype=torch.int32)
        return [paged_decode_attention(
            q, pool.k_fp[i], pool.v_fp[i], pool.k_codes[i], pool.v_codes[i],
            pool.k_cb[i], pool.v_cb[i], pool.blk_q, bt, valid,
            quantized=False) for i in range(cfg.n_layers)]
    for a, b in zip(decode(src, blocks), decode(dst, new)):
        assert torch.equal(a, b)


def _reference_pool(bs, data, pool=None):
    """The reference's reduced qwen3 pool (one leaf, the layers on its
    stacked group axis) holding ``data`` (k, v as (nL, nb, bs, Hkv, Dh)),
    and, given a quantized port ``pool``, its codes, codebooks and
    flags."""
    jcfg = jax_reduced_config("qwen3_0_6b")
    q = pool is not None and pool.quantized
    tree = jax_init_paged_cache(jcfg, num_blocks=data[0].shape[1],
                                block_size=bs, batch=1, max_blocks=4,
                                quantized=q, num_values=16)
    (leaf,) = collect_leaves(tree)
    assert leaf.k_fp.shape == data[0].shape
    leaf = dataclasses.replace(leaf, k_fp=jnp.asarray(data[0]),
                               v_fp=jnp.asarray(data[1]))
    if q:
        leaf = dataclasses.replace(leaf, **{
            n: jnp.asarray(getattr(pool, n).numpy()) for n in
            ("k_codes", "v_codes", "k_cb", "v_cb", "blk_q")})
    return leaf


@pytest.mark.parametrize("bs,P", [(8, 20), (8, 16), (8, 5)])
def test_payload_equals_the_references(bs, P):
    """The same pages extracted by both packages: equal full pages, tail
    rows and byte counts (the reference's layout with the layers on the
    stacked group axis)."""
    cfg, src, _ = _pools("qwen3_0_6b", bs)
    blocks = [3, 1, 4]
    ref = jax_extract_pages(
        _reference_pool(bs, (src.k_fp.numpy(), src.v_fp.numpy())), blocks,
        P, block_size=bs, mode="fp").to_host()
    ours = extract_pages(src, blocks, P, block_size=bs, mode="fp").to_host()
    assert (ours.n_full, ours.tail_rows, ours.n_pages, ours.blocks) == (
        ref.n_full, ref.tail_rows, ref.n_pages, ref.blocks)
    assert (ours.nbytes, ours.fp_equiv_bytes) == (ref.nbytes,
                                                  ref.fp_equiv_bytes)
    for name in ("full", "tail"):
        r, o = getattr(ref, name), getattr(ours, name)
        assert (r is None) == (o is None), name
        if r is not None:
            np.testing.assert_array_equal(o.numpy(), r[0])


def test_splice_payload_is_a_no_op_and_staging_counts_no_bytes():
    _, src, dst = _pools("qwen3_0_6b", 8)
    before = _snapshot(dst)
    p = splice_of([5, 2, 7], 20, 8, shared_pages=1)
    assert p.staged and p.is_ready() and p.to_host().nbytes == 0
    assert (p.n_full, p.tail_rows, p.shared_pages) == (2, 4, 1)
    assert splice_payload(dst, p, [1, 2, 3]) is dst
    for name, t in before.items():
        assert torch.equal(getattr(dst, name), t)
    fin = FinishedPrefill(req=None, first_token=3, payload=p,
                          rng=np.random.default_rng(0))
    assert fin.blocks == [5, 2, 7] and fin.shared_pages == 1


def test_splice_refuses_what_does_not_fit():
    cfg, src, dst = _pools("qwen3_0_6b", 8)
    payload = extract_pages(src, [1, 2, 3], 20, block_size=8, mode="fp")
    with pytest.raises(ValueError, match="destination blocks"):
        splice_payload(dst, payload, [4, 5])
    other = init_paged_cache(get_reduced_config("glm4_9b"), num_blocks=6,
                             block_size=8, device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        splice_payload(other, payload, [1, 2, 3])
    with pytest.raises(ValueError, match="block size"):
        splice_payload(init_paged_cache(cfg, num_blocks=6, block_size=4,
                                        device="cpu"), payload, [1, 2, 3])
    with pytest.raises(ValueError, match="fewer than"):
        extract_pages(src, [1, 2], 20, block_size=8, mode="fp")


@pytest.mark.parametrize("mode", ["frozen", "resident"])
def test_later_modes_raise_naming_the_roadmap(mode):
    """The later modes, once unported, now move: the check takes them, and
    only a mode outside the reference's four (here the later mode's name
    misspelt) raises ValueError, at the check, the extraction and the
    splice."""
    assert MODES == ("splice", "fp", "frozen", "resident")
    _, src, dst = _pools("qwen3_0_6b", 8)
    check_mode(mode)
    unknown = mode + "s"
    with pytest.raises(ValueError, match="migrate mode"):
        check_mode(unknown)
    with pytest.raises(ValueError, match="migrate mode"):
        extract_pages(src, [1, 2, 3], 20, block_size=8, mode=unknown)
    p = PagePayload(mode=unknown, blocks=[1], n_tokens=8, block_size=8,
                    n_full=1, tail_rows=0)
    with pytest.raises(ValueError, match="migrate mode"):
        splice_payload(dst, p, [1])


def test_payload_waits_for_nothing_on_the_cpu_and_stages_once():
    _, src, _ = _pools("qwen3_0_6b", 8)
    p = extract_pages(src, [1, 2, 3], 20, block_size=8, mode="fp")
    assert p.event is None and p.is_ready()
    full = p.full
    # the payload owns its pages: a later write to the pool leaves it
    src.k_fp[:, 1] += 1.0
    src.k_fp[:, 3, :4] += 1.0
    p.to_host()
    assert p.full is full or torch.equal(p.full, full)
    assert not torch.equal(p.full[0, :, 0], src.k_fp[:, 1])
    assert not torch.equal(p.tail[0], src.k_fp[:, 3, :4])
    n = p.nbytes
    assert p.to_host().nbytes == n and p.staged


# ------------------------------------------------------ frozen migration

SPEC = "kmeans_ls@16"


def _quantized_pools(arch, bs, seed=0):
    """A quantized prefill-sized source pool and a quantized decode pool of
    another size (random fp rows everywhere; the destination's codes
    random and every third page flagged frozen)."""
    cfg, _, dst = _pools(arch, bs, seed)
    max_blocks = -(-48 // bs)
    src = init_paged_cache(cfg, num_blocks=2 * max_blocks + 1,
                           block_size=bs, quantized=True, num_values=16,
                           device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for name in ("k_fp", "v_fp"):
        t = getattr(src, name)
        t.copy_(torch.randn(t.shape, generator=g))
    return cfg, src, dst


def _clone_pool(pool):
    return dataclasses.replace(pool, **{
        n: getattr(pool, n).clone() for n in
        ("k_fp", "v_fp", "k_codes", "v_codes", "k_cb", "v_cb", "blk_q")})


@pytest.mark.parametrize("arch,bs,P", CASES)
def test_frozen_migration_lands_an_in_place_freeze_between_pools(arch, bs,
                                                                 P):
    """extract(frozen) -> to_host -> splice between pools of different
    strides: each full page lands as freezing it in place on the source
    pool leaves it (codes, codebooks, reconstruction, flag; bitwise), the
    tail's valid rows as they were, everything else untouched; the bytes
    are the codes, codebooks and tail rows."""
    cfg, src, dst = _quantized_pools(arch, bs)
    assert src.k_fp.stride(0) != dst.k_fp.stride(0)
    n_full, r = divmod(P, bs)
    n_pages = n_full + (1 if r else 0)
    blocks = list(range(src.k_fp.shape[1] - 1, 0, -1))[:n_pages]
    new = [b for b in range(1, dst.k_fp.shape[1]) if b % 3][:n_pages]
    before, in_place = _snapshot(dst), _clone_pool(src)
    freeze_blocks(in_place, blocks[:n_full], SPEC)
    payload = extract_pages(src, blocks, P, block_size=bs, mode="frozen",
                            spec=SPEC)
    assert payload.is_ready() and payload.full is None
    assert sorted(payload.frozen_idx) == list(range(n_full))
    payload.to_host()
    codes, cb = payload.frozen
    tail = 0 if payload.tail is None else payload.tail.numel() * 4
    assert payload.nbytes == codes.numel() + cb.numel() * 4 + tail
    assert payload.fp_equiv_bytes == (2 * cfg.n_layers * P * cfg.n_kv_heads
                                      * cfg.head_dim * 4)
    splice_payload(dst, payload, new)
    for name in ("k_fp", "v_fp", "k_codes", "v_codes", "k_cb", "v_cb"):
        d, ref, d0 = getattr(dst, name), getattr(in_place, name), before[name]
        for j in range(n_full):
            assert torch.equal(d[:, new[j]], ref[:, blocks[j]]), (name, j)
        rest = [b for b in range(d.shape[1]) if b not in new[:n_full]
                and not (r and b == new[n_full] and name.endswith("fp"))]
        assert torch.equal(d[:, rest], d0[:, rest]), name
    assert dst.blk_q[new[:n_full]].all()
    if r:
        for name in ("k_fp", "v_fp"):
            d, t = getattr(dst, name), new[n_full]
            assert torch.equal(d[:, t, :r],
                               getattr(src, name)[:, blocks[n_full], :r])
            assert torch.equal(d[:, t, r:], before[name][:, t, r:])
        assert bool(dst.blk_q[new[n_full]]) == bool(before["blk_q"][
            new[n_full]])


@pytest.mark.parametrize("bs,P", [(8, 20), (8, 16), (8, 5), (16, 37)])
def test_frozen_payload_codes_equal_the_references(bs, P):
    """The same pages frozen-extracted by both packages: equal codes and
    codebooks (within 1e-6) row for row (the port keeps the solve's sorted
    order, ``frozen_idx``; the reference gathers back to sequence order),
    tails and byte counts."""
    cfg, src, _ = _quantized_pools("qwen3_0_6b", bs)
    blocks = [3, 1, 4, 2, 5][:-(-P // bs)]
    ref = jax_extract_pages(
        _reference_pool(bs, (src.k_fp.numpy(), src.v_fp.numpy()), src),
        blocks, P, block_size=bs, mode="frozen",
        spec=jax_resolve_kv_spec(SPEC)).to_host()
    ours = extract_pages(src, blocks, P, block_size=bs, mode="frozen",
                         spec=SPEC).to_host()
    assert (ours.nbytes, ours.fp_equiv_bytes) == (ref.nbytes,
                                                  ref.fp_equiv_bytes)
    if ours.n_full:
        (rc, rcb), = ref.frozen
        order = ours.frozen_idx
        np.testing.assert_array_equal(ours.frozen[0].numpy(),
                                      rc[:, :, order])
        np.testing.assert_allclose(ours.frozen[1].numpy(),
                                   rcb[:, :, order], atol=1e-6, rtol=0)
    else:
        assert ours.frozen is None and ref.frozen is None
    assert (ours.tail is None) == (ref.tail is None)
    if ours.tail is not None:
        np.testing.assert_array_equal(ours.tail.numpy(), ref.tail[0])


def test_frozen_extraction_refuses_what_it_cannot_solve():
    _, src, dst = _pools("qwen3_0_6b", 8)          # src is an fp pool
    with pytest.raises(ValueError, match="quantized pool"):
        extract_pages(src, [1, 2, 3], 20, block_size=8, mode="frozen",
                      spec=SPEC)
    _, qsrc, _ = _quantized_pools("qwen3_0_6b", 8)
    with pytest.raises(ValueError, match="kv_quant spec"):
        extract_pages(qsrc, [1, 2, 3], 20, block_size=8, mode="frozen")
    p = extract_pages(qsrc, [1, 2, 3], 20, block_size=8, mode="frozen",
                      spec=SPEC)
    with pytest.raises(ValueError, match="quantized pool only"):
        splice_payload(src, p, [4, 5, 6])
    for mode in ("splice", "resident"):
        with pytest.raises(ValueError, match="extract_pages builds"):
            extract_pages(qsrc, [1, 2, 3], 20, block_size=8, mode=mode)


# ------------------------------------------------------ resident payloads


@pytest.mark.parametrize("arch,bs,P", CASES)
def test_resident_round_trip_is_bitwise(arch, bs, P):
    """A live sequence whose full pages are partly installed-frozen:
    extract_resident_pages -> to_host -> splice into a pool of another
    stride lands the frozen pages' codes, codebooks, reconstruction and
    flag, the fp pages and the tail rows bitwise, and leaves the rest as
    it was; a decode over the landed pages equals one over the source."""
    cfg, src, dst = _quantized_pools(arch, bs)
    n_full, r = divmod(P, bs)
    n_pages = n_full + (1 if r else 0)
    blocks = list(range(src.k_fp.shape[1] - 1, 0, -1))[:n_pages]
    frozen_idx = [j for j in range(n_full) if j % 2 == 0]
    freeze_blocks(src, [blocks[j] for j in frozen_idx], SPEC)
    new = [b for b in range(1, dst.k_fp.shape[1]) if b % 3][:n_pages]
    dst.blk_q[new] = False            # freshly allocated pages are thawed
    before = _snapshot(dst)
    payload = extract_resident_pages(src, blocks, P, frozen_idx + [n_full],
                                     block_size=bs)
    assert payload.frozen_idx == frozen_idx
    payload.to_host()
    splice_payload(dst, payload, new)
    fset = set(frozen_idx)
    for name in ("k_fp", "v_fp", "k_codes", "v_codes", "k_cb", "v_cb"):
        d, s_, d0 = getattr(dst, name), getattr(src, name), before[name]
        for j in range(n_full):
            want = s_[:, blocks[j]] if (j in fset or name.endswith("fp")) \
                else d0[:, new[j]]
            assert torch.equal(d[:, new[j]], want), (name, j)
        rest = [b for b in range(d.shape[1]) if b not in new[:n_pages]]
        assert torch.equal(d[:, rest], d0[:, rest]), name
    assert [bool(dst.blk_q[new[j]]) for j in range(n_full)] == [
        j in fset for j in range(n_full)]
    if r:
        for name in ("k_fp", "v_fp"):
            d, t = getattr(dst, name), new[n_full]
            assert torch.equal(d[:, t, :r],
                               getattr(src, name)[:, blocks[n_full], :r])
    q = torch.randn(1, cfg.n_heads, cfg.head_dim,
                    generator=torch.Generator().manual_seed(2))
    valid = torch.tensor([P], dtype=torch.int32)

    def decode(pool, table):
        bt = torch.tensor([table], dtype=torch.int32)
        return [paged_decode_attention(
            q, pool.k_fp[i], pool.v_fp[i], pool.k_codes[i], pool.v_codes[i],
            pool.k_cb[i], pool.v_cb[i], pool.blk_q, bt, valid,
            quantized=True, packed=True) for i in range(cfg.n_layers)]
    for a, b in zip(decode(src, blocks), decode(dst, new)):
        assert torch.equal(a, b)


def test_resident_payload_equals_the_references():
    """The same live pages demoted by both packages: equal fp pages,
    codes, codebooks, tail and bytes (resident payloads keep sequence
    order in both)."""
    bs, P = 8, 37
    cfg, src, _ = _quantized_pools("qwen3_0_6b", bs)
    blocks = [6, 2, 9, 4, 1]
    frozen_idx = [0, 2, 3]
    freeze_blocks(src, [blocks[j] for j in frozen_idx], SPEC)
    ref = jax_extract_resident(
        _reference_pool(bs, (src.k_fp.numpy(), src.v_fp.numpy()), src),
        blocks, P, frozen_idx, block_size=bs).to_host()
    ours = extract_resident_pages(src, blocks, P, frozen_idx,
                                  block_size=bs).to_host()
    assert (ours.nbytes, ours.fp_equiv_bytes, ours.frozen_idx) == (
        ref.nbytes, ref.fp_equiv_bytes, ref.frozen_idx)
    np.testing.assert_array_equal(ours.full.numpy(), ref.full[0])
    np.testing.assert_array_equal(ours.tail.numpy(), ref.tail[0])
    (rc, rcb), = ref.frozen
    np.testing.assert_array_equal(ours.frozen[0].numpy(), rc)
    np.testing.assert_array_equal(ours.frozen[1].numpy(), rcb)
