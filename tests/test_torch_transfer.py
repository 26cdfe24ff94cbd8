"""fp page migration (``repro_torch.serving.transfer``) held to the
reference's ``repro.serving.transfer`` on the same pages, and to itself
across pools of different sizes.

A prefill pool (fp, ``2 * max_prompt_blocks + 1`` pages) and a decode pool
(kmeans_ls@16, ``max_slots * max_blocks + 1`` pages) pad their layer
strides differently (``kv_cache._pool_tensors``), so a splice that indexed
by flat offset would land pages in the wrong layer. Reduced qwen3 at
blocks 8 and 16 and reduced glm4 (Dh 8) at blocks 1, 5 and 7 (its code
pages are not whole 16-byte pieces there, so the decode pool is padded).

Tolerance: none. Landed pages, tail rows and the untouched rest are
bitwise; the payload's tensors equal the reference's bitwise (both copy
the same f32 values); a decode over landed pages equals one over the
source pages bitwise.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced_config
from repro.serving import extract_pages as jax_extract_pages
from repro.serving import init_paged_cache as jax_init_paged_cache
from repro.serving.transfer import collect_leaves
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import paged_decode_attention
from repro_torch.serving import (FinishedPrefill, PagePayload,
                                 extract_pages, init_paged_cache,
                                 splice_payload)
from repro_torch.serving.transfer import check_mode, splice_of

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


def _reference_pool(bs, data):
    """The reference's reduced qwen3 pool (one leaf, the layers on its
    stacked group axis) holding ``data`` (k, v as (nL, nb, bs, Hkv, Dh))."""
    jcfg = jax_reduced_config("qwen3_0_6b")
    tree = jax_init_paged_cache(jcfg, num_blocks=data[0].shape[1],
                                block_size=bs, batch=1, max_blocks=4)
    (leaf,) = collect_leaves(tree)
    assert leaf.k_fp.shape == data[0].shape
    return dataclasses.replace(leaf, k_fp=jnp.asarray(data[0]),
                               v_fp=jnp.asarray(data[1]))


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
    _, src, dst = _pools("qwen3_0_6b", 8)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A5c"):
        check_mode(mode)
    with pytest.raises(NotImplementedError, match="A5c"):
        extract_pages(src, [1, 2, 3], 20, block_size=8, mode=mode)
    p = PagePayload(mode=mode, blocks=[1], n_tokens=8, block_size=8,
                    n_full=1, tail_rows=0)
    with pytest.raises(NotImplementedError, match="A5c"):
        splice_payload(dst, p, [1])
    with pytest.raises(ValueError, match="migrate mode"):
        check_mode("codes")


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
