"""Prefix sharing in the port (``serving/kv_cache.py:PrefixIndex``, the
copy-on-write attach in ``serving/workers.py``, the admission discount in
``serving/scheduler.py``), on the reduced qwen3 config (f32, CPU).

The index is held against the reference's on the same publish, lookup and
invalidate sequences. Shared against unshared replays on an fp pool are
held to the port's chunked-vs-whole CPU bar, logits within atol 1e-4 (a
prefill past spliced pages runs matmuls of other row counts than a
whole-prompt prefill), and to identical greedy tokens. The refcount
partition is checked at every engine step.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serving.kv_cache import PrefixIndex as JaxPrefixIndex
from repro_torch import models
from repro_torch.configs import get_reduced_config
from repro_torch.serving import (ContinuousBatchingEngine,
                                 ContinuousBatchingScheduler, PrefixIndex,
                                 Request, derive_draft, poisson_trace)
from repro.serving.scheduler import poisson_trace as jax_poisson_trace

# tiny tensors: one intra-op thread (more make these shapes far slower)
torch.set_num_threads(1)

pytestmark = pytest.mark.serving


@pytest.fixture(scope="module")
def reduced():
    cfg = get_reduced_config("qwen3_0_6b")
    params = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, params


# ------------------------------------------------------------- the index


def test_prefix_index_chain_lookup_and_invalidate():
    """The reference's own index test, on the port's index."""
    idx = PrefixIndex(4)
    toks = list(range(12))                # 3 full pages at block size 4
    assert idx.publish(toks, [1, 2, 3], None) == 3
    assert len(idx) == 3
    assert idx.lookup(toks, 3) == [1, 2, 3]
    assert idx.lookup(toks, 2) == [1, 2]             # the caller's CoW cap
    assert idx.lookup(toks[:8] + [99] * 4, 3) == [1, 2]   # tail diverges
    assert idx.lookup([99] + toks[1:], 3) == []      # first page differs
    assert idx.lookup(toks[:7], 3) == [1]            # partial page ignored
    # a chain is contiguous from the root: frozen gating stops it
    gated = PrefixIndex(4)
    assert gated.publish(toks, [4, 5, 6], frozen={4, 6}) == 1
    assert gated.lookup(toks, 3) == [4]
    # idempotent, first publisher wins
    assert idx.publish(toks, [7, 8, 9], None) == 0
    assert idx.lookup(toks, 3) == [1, 2, 3]
    idx.invalidate([2])                   # page 2's last ref dropped
    assert idx.lookup(toks, 3) == [1], "the chain breaks at a dead page"
    idx.invalidate([1, 3])
    assert len(idx) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_index_matches_reference_index(seed):
    """A seeded sequence of publishes (some frozen-gated), lookups and
    invalidations over prompts that share prefixes: both indexes return
    the same ids, sizes and added counts at every step."""
    rng = np.random.default_rng(seed)
    bs = 4
    ours, theirs = PrefixIndex(bs), JaxPrefixIndex(bs)
    roots = [rng.integers(0, 50, 12).tolist() for _ in range(3)]
    next_bid = 1
    live = []
    for _ in range(60):
        op = rng.integers(0, 3)
        toks = (roots[rng.integers(0, 3)][:int(rng.integers(0, 13))]
                + rng.integers(0, 50, int(rng.integers(0, 9))).tolist())
        if op == 0:
            n = len(toks) // bs
            blocks = list(range(next_bid, next_bid + n))
            next_bid += n
            live += blocks
            frozen = (None if rng.integers(0, 2) else
                      {b for b in blocks if rng.random() < 0.8})
            assert ours.publish(toks, blocks, frozen) == theirs.publish(
                toks, blocks, frozen)
        elif op == 1:
            cap = int(rng.integers(0, 4))
            assert ours.lookup(toks, cap) == theirs.lookup(toks, cap)
        elif live:
            gone = rng.choice(live, size=min(len(live), 3),
                              replace=False).tolist()
            ours.invalidate(gone)
            theirs.invalidate(gone)
        assert len(ours) == len(theirs)
        assert ours._map == theirs._map


def test_shared_prefix_trace_matches_reference():
    kw = dict(vocab=499, prompt_len=12, max_new_tokens=5, seed=3)
    for shared in (0, 8):
        ours = poisson_trace(4, 4.0, shared_prefix_len=shared, **kw)
        ref = jax_poisson_trace(4, 4.0, shared_prefix_len=shared, **kw)
        for a, b in zip(ours, ref):
            assert (a.prompt, a.arrival_time, a.seed) == (
                b.prompt, b.arrival_time, b.seed)
        assert len({r.prompt[:shared] for r in ours}) == 1
    with pytest.raises(ValueError, match="shared_prefix_len"):
        poisson_trace(2, 4.0, shared_prefix_len=13, **kw)


# ------------------------------------------------------------- admission


def test_admission_charges_worst_case_minus_shareable_pages():
    """``schedule(discount=)`` charges each request its worst-case pages
    less the pages its prompt would share."""
    s = ContinuousBatchingScheduler(max_slots=3, block_size=8, lookahead=2)
    reqs = [Request(id=i, prompt=(1,) * 20, max_new_tokens=10)
            for i in range(3)]
    assert s.blocks_for(reqs[0]) == 4             # ceil((20 + 10 + 2) / 8)
    for r in reqs:
        s.submit(r)
    # 9 free pages: two fit at full price, all three with 2 shared each
    assert [st.req.id for st in s.schedule(free_blocks=9)] == [0, 1]
    s2 = ContinuousBatchingScheduler(max_slots=3, block_size=8, lookahead=2)
    for r in reqs:
        s2.submit(r)
    admitted = s2.schedule(free_blocks=9, discount=lambda r: 2)
    assert [st.req.id for st in admitted] == [0, 1, 2]


def test_engine_probe_discounts_published_pages(reduced):
    """The worker's probe counts the published pages a prompt would
    splice (capped one page short of its last token), and an admitted
    prefill draws exactly worst case minus those from the pool."""
    cfg, params = reduced
    eng = ContinuousBatchingEngine(params, cfg, device="cpu", max_slots=2,
                                   block_size=8, max_seq_len=64,
                                   prefix_cache=True)
    w = eng.worker
    common = list(range(1, 25))                   # 3 full pages
    a = Request(id=0, prompt=tuple(common + [30, 31]), max_new_tokens=20)
    b = Request(id=1, prompt=tuple(common + [40]), max_new_tokens=4)
    c = Request(id=2, prompt=tuple(common), max_new_tokens=4)
    assert w.prefix_probe(b) == 0
    w.submit(a, 0.0)
    (st,) = w.sched.schedule(w.alloc.num_free)
    w.attach(st, eng.prefill.run_inline(a, lambda: 0.0), 0.0)
    assert w.prefix_probe(b) == 3
    assert w.prefix_probe(c) == 2                 # one page short of P
    free = w.alloc.num_free
    w.submit(b, 0.0)
    (st,) = w.sched.schedule(w.alloc.num_free, discount=w.prefix_probe)
    fin = eng.prefill.run_inline(b, lambda: 0.0)
    assert free - w.alloc.num_free == w.sched.blocks_for(b) - 3
    assert fin.shared_pages == 3 and fin.blocks[:3] == w.slots[0].blocks[:3]
    assert [w.alloc.refcount(x) for x in fin.blocks[:4]] == [2, 2, 2, 1]
    w.attach(st, fin, 0.0)
    assert [w.shared_prefix_pages(i) for i in (0, 1)] == [3, 3]


# ------------------------------------------------------------- replays


def _shared_requests(cfg, rng, shapes, shared_tokens):
    """Requests whose prompts share a ``shared_tokens``-long prefix."""
    common = tuple(int(x) for x in rng.integers(0, cfg.vocab, shared_tokens))
    return [Request(id=i, prompt=common + tuple(
                int(x) for x in rng.integers(0, cfg.vocab, extra)),
                    max_new_tokens=gen)
            for i, (extra, gen) in enumerate(shapes)]


@pytest.mark.parametrize("shapes,prefill_chunk", [
    ([(5, 2), (5, 7), (5, 4)], None),
    ([(0, 2), (0, 7), (0, 4)], None),
    ([(5, 14), (5, 2), (5, 4)], 5)])
def test_shared_replay_matches_unshared_on_an_fp_pool(reduced, shapes,
                                                      prefill_chunk):
    """Copy-on-write is invisible in the numerics: on an fp pool (shared
    pages are exact prompt rows) sharing changes which pages serve the
    prefix, not what the model sees (the reference's COW-divergence
    property, tests/test_properties.py:448, block 8, 24 shared tokens).
    Page-aligned prompts splice one page short of their last token and
    count the copy-on-write."""
    cfg, params = reduced
    rng = np.random.default_rng(sum(e for e, _ in shapes) + 24)
    requests = _shared_requests(cfg, rng, shapes, 24)
    engines = []
    for pc in (False, True):
        eng = ContinuousBatchingEngine(
            params, cfg, device="cpu", max_slots=2, block_size=8,
            max_seq_len=64, record_logits=True, prefix_cache=pc,
            prefill_chunk=prefill_chunk)
        eng.run([dataclasses.replace(r) for r in requests])
        assert eng.worker.alloc.num_free == eng.worker.num_blocks - 1
        engines.append(eng)
    base, shared = engines
    assert base.outputs == shared.outputs
    for i in range(len(requests)):
        np.testing.assert_allclose(shared.request_logits[i],
                                   base.request_logits[i], atol=1e-4,
                                   rtol=0)
    c = shared.counters
    assert c["prefix_hits"] >= 1
    if shapes[0][0]:
        assert c["prefix_shared_pages"] >= 3
    else:
        assert c["cow_copies"] >= 1 and c["prefix_shared_pages"] >= 2
    assert len(shared.worker.prefix) == 0      # drained with the pool


def _assert_pool_partition(w):
    """The free list and the refcounted live tables partition the
    allocatable pool; a page held by N live tables has refcount N."""
    held = {}
    for i in w.sched.active_slots():
        for b in w.slots[i].blocks:
            held[int(b)] = held.get(int(b), 0) + 1
    free = set(w.alloc._free)
    assert len(free) == len(w.alloc._free)
    assert not free & set(held)
    staged = set(w.alloc._used) - set(held)    # prefills in flight
    assert free | set(held) | staged == set(range(1, w.num_blocks))
    for b, n in held.items():
        assert w.alloc.refcount(b) >= n, (b, n)
        if b not in staged:
            assert w.alloc.refcount(b) == n, (b, n, w.alloc.refcount(b))


@pytest.mark.parametrize("speculate", [0, 2])
def test_refcount_partition_with_sharing_and_speculation(reduced,
                                                         speculate):
    """Shared attach and finish interleaved with async freeze installs
    and (speculate 2) rollback: the pool stays an exact partition at
    every step, and the pool and the index drain to empty."""
    cfg, params = reduced
    eng = ContinuousBatchingEngine(
        params, cfg, device="cpu", max_slots=2, block_size=8,
        max_seq_len=48, kv_quant="kmeans_ls@16", freeze_page_budget=2,
        num_blocks=10, prefix_cache=True, prefill_chunk=None,
        speculate=speculate,
        draft=derive_draft(params, cfg) if speculate else None)
    w = eng.worker
    orig_step = w.step

    def checked_step(now_fn):
        orig_step(now_fn)
        _assert_pool_partition(w)

    w.step = checked_step
    rng = np.random.default_rng(0)
    shapes = [(int(rng.integers(2, 9)), int(rng.integers(4, 13)))
              for _ in range(4)]
    # all at t = 0 into two slots: the later two are admitted as slots
    # free up, when the live sequence's prompt pages are installed-frozen
    eng.run(_shared_requests(cfg, rng, shapes, 16))
    _assert_pool_partition(w)
    assert sorted(eng.outputs) == list(range(len(shapes)))
    assert w.alloc.num_free == w.num_blocks - 1
    assert not w._pending_freezes and not w._freeze_bids
    assert len(w.prefix) == 0
    assert w.counters["prefix_hits"] >= 1
