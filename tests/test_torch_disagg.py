"""Disaggregated serving (``repro_torch.serving.DisaggEngine``): the
router's decisions against the reference router on the same fakes, fp
and frozen page migration against the colocated engine and against the
reference's ``DisaggEngine`` on carried weights (reduced qwen3 and glm4,
f32), worker ratios, sampling determinism, the freeze budget, async
freezes outliving their sequences, the TTFT split, and what the engine
refuses. Mirrors ``tests/test_disagg.py``.

Tolerances: disagg fp against colocated, inside the port, equal greedy
tokens and request logits within atol 1e-4 (the reference test's bar:
the pages cross unchanged, only the decode batches' composition differs);
disagg frozen against colocated with synchronous freezing the same (the
solver sees the same pages on either pool); fused against gather on
frozen-migrated pages within 1e-3 (the reference test's bar);
against the reference engine, equal greedy tokens and logits within atol
1e-3 (the reference's engine bar, as ``tests/test_torch_serving.py``);
the ``migrate_*`` counters equal the reference's exactly.
"""
import jax
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_reduced_config as jax_reduced_config
from repro.serving import DisaggEngine as JaxDisaggEngine
from repro.serving import DisaggRouter as JaxRouter
from repro.serving import Request as JaxRequest
from repro.serving import sample_token as jax_sample_token
from repro_torch import models
from repro_torch.configs import get_reduced_config
from repro_torch.serving import (ContinuousBatchingEngine, DisaggEngine,
                                 DisaggRouter, PrefillWorker, Request,
                                 page_bytes, sample_token)

# tiny tensors: one intra-op thread (more make these shapes far slower)
torch.set_num_threads(1)

pytestmark = pytest.mark.serving

ROUTERS = [(DisaggRouter, Request), (JaxRouter, JaxRequest)]


# ------------------------------------------------------------- router


class _FakePrefill:
    def __init__(self, wid, load=0, cap=4):
        self.worker_id, self.load, self.cap = wid, load, cap
        self.got = []

    def can_accept(self):
        return self.load < self.cap

    def submit(self, req):
        self.got.append(req.id)
        self.load += 1


class _FakeDecode:
    def __init__(self, wid, free_slots=1, free_blocks=8, block_size=4):
        self.worker_id, self.free_slots = wid, free_slots
        self.free_blocks, self.block_size = free_blocks, block_size
        self.got = []

    def can_accept(self, req):
        need = -(-(req.prompt_len + req.max_new_tokens) // self.block_size)
        return self.free_slots > 0 and need <= self.free_blocks

    def place(self, fin):
        self.got.append(fin.req.id)
        self.free_slots -= 1
        self.free_blocks -= -(-(fin.req.prompt_len
                                + fin.req.max_new_tokens) // self.block_size)


class _FakeFin:
    def __init__(self, req):
        self.req = req


def _both(scenario):
    """``scenario(Router, Request)`` on the port's router and the
    reference's; their observations must be equal."""
    port, ref = (scenario(*r) for r in ROUTERS)
    assert port == ref
    return port


def test_router_prefill_least_loaded_under_imbalance():
    """Requests drain to the least-loaded prefill worker; a saturated
    worker is skipped; ties break on worker id."""
    def scenario(Router, Req):
        router = Router()
        a, b, c = (_FakePrefill(0, load=3), _FakePrefill(1, load=0),
                   _FakePrefill(2, load=0, cap=0))
        for i in range(5):
            assert router.submit(Req(id=i, prompt=(1,) * 4,
                                     max_new_tokens=4))
        router.route_prefill([a, b, c])
        return a.got, b.got, c.got, len(router.waiting)
    a, b, c, waiting = _both(scenario)
    assert c == [] and b == [0, 1, 2, 4] and a == [3] and waiting == 0


def test_router_queue_admission_control():
    def scenario(Router, Req):
        router = Router(max_queue=2)
        ok = [router.submit(Req(id=i, prompt=(1,) * 4, max_new_tokens=4))
              for i in range(3)]
        return ok, router.rejected
    assert _both(scenario) == ([True, True, False], [2])


def test_router_decode_reevaluates_capacity_per_placement():
    """Two staged prefills are not both placed against the capacity the
    first is about to consume."""
    def scenario(Router, Req):
        router = Router()
        dw = _FakeDecode(0, free_slots=1, free_blocks=8)
        for i in range(2):
            router.stage(_FakeFin(Req(id=i, prompt=(1,) * 4,
                                      max_new_tokens=4)))
        placed = router.route_decode([dw], lambda w, fin: w.place(fin))
        first = ([f.req.id for _, f in placed], list(dw.got),
                 len(router.staged))
        dw.free_slots = 1
        router.route_decode([dw], lambda w, fin: w.place(fin))
        return first, dw.got, len(router.staged)
    first, got, staged = _both(scenario)
    assert first == ([0], [0], 1) and got == [0, 1] and staged == 0


def test_router_decode_most_free_slots_and_hol_wait():
    """Placement prefers the emptiest decode worker; a head that fits
    nowhere blocks the queue (FCFS)."""
    def scenario(Router, Req):
        router = Router()
        small = _FakeDecode(0, free_slots=2, free_blocks=2)
        big = _FakeDecode(1, free_slots=1, free_blocks=64)
        router.stage(_FakeFin(Req(id=0, prompt=(1,) * 32,
                                  max_new_tokens=32)))
        router.stage(_FakeFin(Req(id=1, prompt=(1,) * 4, max_new_tokens=4)))
        placed = router.route_decode([small, big],
                                     lambda w, fin: w.place(fin))
        first = [(w.worker_id, f.req.id) for w, f in placed]
        router.stage(_FakeFin(Req(id=2, prompt=(1,) * 32,
                                  max_new_tokens=32)))
        router.stage(_FakeFin(Req(id=3, prompt=(1,) * 4, max_new_tokens=4)))
        blocked = router.route_decode([small, big],
                                      lambda w, fin: w.place(fin))
        return first, len(blocked), len(router.staged)
    assert _both(scenario) == ([(1, 0), (0, 1)], 0, 2)


def test_staging_depth_backpressures_prefill():
    """With a staging depth, a decode stall stops route_prefill once
    in-flight prefills reach it; freed decode capacity reopens intake.
    Without one, everything flows to the workers."""
    def scenario(Router, Req):
        req = lambda i: Req(id=i, prompt=(1,) * 4, max_new_tokens=4)
        router = Router(staging_depth=2)
        pw, dec = _FakePrefill(0), _FakeDecode(0, free_slots=0)
        for i in range(6):
            router.submit(req(i))
        obs = [len(router.route_prefill([pw])), pw.load]
        for i in range(2):
            router.stage(_FakeFin(req(i)))
            pw.load -= 1
        obs += [len(router.route_decode([dec], lambda w, f: w.place(f))),
                len(router.route_prefill([pw])), len(router.waiting)]
        dec.free_slots = 2
        obs += [len(router.route_decode([dec], lambda w, f: w.place(f))),
                len(router.route_prefill([pw]))]
        free = Router()
        pw2 = _FakePrefill(0, cap=64)
        for i in range(6):
            free.submit(req(i))
        return obs + [len(free.route_prefill([pw2]))]
    assert _both(scenario) == [2, 2, 0, 0, 4, 2, 2, 6]


def test_sample_token_greedy_and_determinism():
    """The engine's sampler draws what the reference's draws from the same
    Generator; greedy is argmax; top-k bounds the support."""
    row = np.asarray([0.1, 3.0, -1.0, 2.9])
    assert sample_token(row) == 1
    for t, k in ((1.0, 0), (2.0, 2), (5.0, 1), (0.7, 3)):
        for seed in range(6):
            assert sample_token(row, temperature=t, top_k=k,
                                rng=np.random.default_rng(seed)) \
                == jax_sample_token(row, temperature=t, top_k=k,
                                    rng=np.random.default_rng(seed))
    assert all(sample_token(row, temperature=2.0, top_k=2,
                            rng=np.random.default_rng(i)) in (1, 3)
               for i in range(20))


# ------------------------------------------------------------- engines


@pytest.fixture(scope="module", params=["qwen3_0_6b", "glm4_9b"])
def reduced(request):
    jcfg = jax_reduced_config(request.param)
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_reduced_config(request.param)
    params = models.params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def qwen():
    cfg = get_reduced_config("qwen3_0_6b")
    return cfg, models.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")


def _prompts(cfg, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n).tolist() for n in lens]


KW = dict(max_slots=2, block_size=8, max_seq_len=32, record_logits=True)


def test_colocated_vs_disagg_fp(reduced):
    """The disaggregated composition gives the colocated engine's greedy
    tokens and logits within 1e-4 on an fp pool, with a prompt that is not
    page-aligned (a tail page migrates), and drains every pool."""
    _, _, cfg, params = reduced
    prompts = _prompts(cfg, 0, (12, 8))
    co = ContinuousBatchingEngine(params, cfg, device="cpu", **KW)
    out_co = co.generate(prompts, max_new_tokens=5)
    dz = DisaggEngine(params, cfg, device="cpu", migrate="fp", **KW)
    out_dz = dz.generate(prompts, max_new_tokens=5)
    assert out_co == out_dz
    for i in range(len(prompts)):
        np.testing.assert_allclose(dz.request_logits[i],
                                   co.request_logits[i], atol=1e-4, rtol=0)
    s = dz.metrics.summary()
    assert s["completed"] == len(prompts)
    c = dz.decode[0].counters
    assert c["migrated_seqs"] == len(prompts)
    assert c["migrated_pages"] == 2 + 1
    assert c["migrate_bytes"] == c["migrate_fp_equiv_bytes"] > 0
    assert dz.decode[0].alloc.num_free == dz.decode[0].num_blocks - 1
    assert dz.prefills[0].alloc.num_free == dz.prefills[0].num_blocks - 1


def test_disagg_matches_reference_disagg_engine(reduced):
    """Carried weights through both packages' DisaggEngine, fp migration
    onto kmeans_ls@16 decode pools with synchronous freezes: equal greedy
    tokens, logits within 1e-3, and equal migration counters."""
    jcfg, jparams, cfg, params = reduced
    prompts = _prompts(cfg, 1, (20, 13, 16))
    kw = dict(KW, max_seq_len=48, kv_quant="kmeans_ls@16",
              freeze_async=False, freeze_page_budget=16)
    ref = JaxDisaggEngine(jparams, jcfg, migrate="fp", attn_impl="gather",
                          **kw)
    ref_out = ref.generate(prompts, max_new_tokens=6)
    ours = DisaggEngine(params, cfg, device="cpu", migrate="fp", **kw)
    out = ours.generate(prompts, max_new_tokens=6)
    assert out == ref_out
    for i in range(len(prompts)):
        np.testing.assert_allclose(ours.request_logits[i],
                                   ref.request_logits[i], atol=1e-3, rtol=0)
    keys = ("migrated_seqs", "migrated_pages", "migrate_bytes",
            "migrate_fp_equiv_bytes")
    theirs = ref._summary()
    s = ours._summary()
    assert {k: s[k] for k in keys} == {k: theirs[k] for k in keys}
    assert s["migrate_compression"] == theirs["migrate_compression"] == 1.0
    assert s["prefills_done"] == theirs["prefills_done"] == len(prompts)
    assert s["freeze_installs"] > 0 and s["host_page_solves"] == 0


def test_disagg_worker_ratio_and_multi_decode(qwen):
    """2 prefill + 2 decode workers: every request completes, sequences
    spread over both decode workers, and the outputs are the colocated
    engine's."""
    cfg, params = qwen
    prompts = _prompts(cfg, 5, (8,) * 4)
    co = ContinuousBatchingEngine(params, cfg, device="cpu", max_slots=4,
                                  block_size=8, max_seq_len=16)
    out_co = co.generate(prompts, max_new_tokens=4)
    dz = DisaggEngine(params, cfg, device="cpu", prefill_workers=2,
                      decode_workers=2, max_slots=2, block_size=8,
                      max_seq_len=16)
    out_dz = dz.generate(prompts, max_new_tokens=4)
    assert out_dz == out_co
    assert sum(p.counters["prefills"] for p in dz.prefills) == 4
    assert all(p.counters["prefills"] > 0 for p in dz.prefills)
    assert all(d.counters["migrated_seqs"] > 0 for d in dz.decode)
    s = dz._summary()
    assert [w["migrated_seqs"] for w in s["per_worker"]["decode"]] == [
        d.counters["migrated_seqs"] for d in dz.decode]
    assert sum(w["migrate_bytes"] for w in s["per_worker"]["prefill"]) \
        == s["migrate_bytes"]


def test_staging_depth_engine_bounds_inflight(qwen):
    """staging_depth=1: never more than one prefill in flight past the
    waiting queue, and the whole trace completes."""
    cfg, params = qwen
    prompts = _prompts(cfg, 9, (8,) * 4)
    eng = DisaggEngine(params, cfg, device="cpu", max_slots=1, block_size=8,
                       max_seq_len=16, staging_depth=1)
    out = eng.generate(prompts, max_new_tokens=4)
    assert all(out[i] is not None and len(out[i]) == 4 for i in range(4))
    assert eng.prefills[0].counters["queue_peak"] <= 1


@pytest.mark.parametrize("disagg", [False, True])
def test_engine_sampling_determinism_per_seed(qwen, disagg):
    """Sampling replays token-identically per seed, differs across seeds,
    and temperature 0 is the greedy path."""
    cfg, params = qwen
    prompts = _prompts(cfg, 6, (8,) * 3)
    Engine = DisaggEngine if disagg else ContinuousBatchingEngine

    def run(seed, temperature=5.0, top_k=16):
        eng = Engine(params, cfg, device="cpu", max_slots=2, block_size=8,
                     max_seq_len=32)
        return eng.generate(prompts, max_new_tokens=8,
                            temperature=temperature, top_k=top_k, seed=seed)

    a, b, c = run(5), run(5), run(6)
    assert a == b and a != c
    eng = Engine(params, cfg, device="cpu", max_slots=2, block_size=8,
                 max_seq_len=32)
    assert eng.generate(prompts, max_new_tokens=8) == run(0, 0.0, 0)


@pytest.mark.parametrize("disagg", [False, True])
def test_freeze_page_budget_defers_burst(qwen, disagg):
    """A burst of full prompt pages beyond the per-step budget defers the
    rest (counted), and every queued page still freezes."""
    cfg, params = qwen
    prompts = _prompts(cfg, 7, (32, 32))
    Engine = DisaggEngine if disagg else ContinuousBatchingEngine
    kw = dict(device="cpu", max_slots=2, block_size=8, max_seq_len=48,
              kv_quant="kmeans_ls@16")
    eng = Engine(params, cfg, freeze_page_budget=2, **kw)
    eng.generate(prompts, max_new_tokens=8)
    c = eng.counters
    assert c["freeze_deferred_pages"] > 0
    assert c["freeze_installs"] == c["freeze_dispatches"] > 0
    eng2 = Engine(params, cfg, freeze_page_budget=64, **kw)
    eng2.generate(prompts, max_new_tokens=8)
    assert eng2.counters["freeze_deferred_pages"] == 0


def test_disagg_async_freeze_outliving_sequences_drains(qwen):
    """An async freeze dispatched right before its sequence finishes still
    lands: the loop keys on pending solves."""
    cfg, params = qwen
    eng = DisaggEngine(params, cfg, device="cpu", max_slots=2, block_size=8,
                       max_seq_len=32, kv_quant="kmeans_ls@16")
    assert eng.freeze_async
    out = eng.generate(_prompts(cfg, 9, (16,)), max_new_tokens=2)
    assert len(out[0]) == 2
    dw = eng.decode[0]
    assert not dw._pending_freezes and not dw._freeze_bids
    assert (dw.counters["freeze_installs"]
            == dw.counters["freeze_dispatches"] > 0)


def test_ttft_split_components(qwen):
    """queue_wait + prefill_compute == TTFT per request, on both
    compositions."""
    cfg, params = qwen
    prompts = _prompts(cfg, 8, (8, 8))
    kw = dict(device="cpu", max_slots=2, block_size=8, max_seq_len=16)
    for eng in (ContinuousBatchingEngine(params, cfg, **kw),
                DisaggEngine(params, cfg, **kw)):
        eng.generate(prompts, max_new_tokens=4)
        s = eng.metrics.summary()
        assert s["queue_wait_mean_s"] >= 0
        assert s["prefill_compute_mean_s"] > 0
        for tr in eng.metrics.traces.values():
            assert tr.queue_wait + tr.prefill_compute == pytest.approx(
                tr.ttft, abs=1e-9)


def test_disagg_speculative_tokens_equal_non_speculative(qwen):
    """The decode workers' speculative path composes with migration: the
    half-depth draft's greedy tokens are the plain disagg engine's."""
    from repro_torch.serving import derive_draft

    cfg, params = qwen
    prompts = _prompts(cfg, 3, (16, 11))
    kw = dict(device="cpu", max_slots=2, block_size=8, max_seq_len=48)
    base = DisaggEngine(params, cfg, **kw).generate(prompts, 9)
    spec = DisaggEngine(params, cfg, speculate=2,
                        draft=derive_draft(params, cfg), **kw)
    assert spec.generate(prompts, 9) == base
    s = spec._summary()
    assert s["draft_prefills"] == len(prompts) and s["spec_proposed"] > 0


def test_disagg_rejects_oversized_and_unported_migration(qwen):
    """Requests no worker can hold are refused at the door, and migration
    is validated as the reference validates it: frozen needs a kv_quant
    spec with a device solver; any mode but fp and frozen raises."""
    cfg, params = qwen
    eng = DisaggEngine(params, cfg, device="cpu", max_slots=1, block_size=8,
                       max_seq_len=16)
    assert not eng.submit(Request(id=7, prompt=(1,) * 12, max_new_tokens=8),
                          0.0)
    assert 7 in eng.router.rejected
    # a prompt past the prefill pool (3 pages) is refused at the door too
    small = DisaggEngine(params, cfg, device="cpu", max_slots=1,
                         block_size=8, max_seq_len=64, prefill_blocks=3)
    assert not small.submit(Request(id=1, prompt=(1,) * 24,
                                    max_new_tokens=2), 0.0)
    assert small.submit(Request(id=2, prompt=(1,) * 16, max_new_tokens=2),
                        0.0)
    with pytest.raises(ValueError, match="kv_quant"):
        DisaggEngine(params, cfg, device="cpu", migrate="frozen")
    with pytest.raises(ValueError, match="device"):
        DisaggEngine(params, cfg, device="cpu", migrate="frozen",
                     kv_quant="dtc@16")
    for mode in ("codes", "splice", "resident"):
        with pytest.raises(ValueError, match="migrate"):
            DisaggEngine(params, cfg, device="cpu", migrate=mode)
    with pytest.raises(ValueError, match="kv_spec"):
        PrefillWorker(params, cfg, device="cpu", migrate="frozen")
    with pytest.raises(ValueError, match="fp or frozen"):
        PrefillWorker(params, cfg, device="cpu", migrate="resident")
    with pytest.raises(ValueError, match="workers"):
        DisaggEngine(params, cfg, device="cpu", decode_workers=0)
    with pytest.raises(ValueError, match="colocated"):
        PrefillWorker(params, cfg, device="cpu", prefill_chunk=4)


def test_disagg_defaults_to_the_card(qwen):
    """Without a GPU the default device raises instead of falling back."""
    cfg, params = qwen
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DisaggEngine(params, cfg)


# ------------------------------------------------------- frozen migration


def test_frozen_migration_matches_colocated_sync_freeze(reduced):
    """migrate="frozen" (full pages solved on the prefill worker's pool,
    crossing as codes + codebooks, landing installed) reproduces the
    colocated engine with synchronous freezing: tokens equal, logits
    within 1e-4; the bytes are the frozen pages' (5x and more under fp on
    qwen3's reduced pool) and no page is solved twice."""
    _, _, cfg, params = reduced
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, 32).tolist() for _ in range(2)]
    kw = dict(max_slots=2, block_size=8, max_seq_len=64,
              kv_quant="kmeans_ls@16", record_logits=True,
              freeze_async=False, freeze_page_budget=64)
    co = ContinuousBatchingEngine(params, cfg, device="cpu", **kw)
    out_co = co.generate(prompts, max_new_tokens=6)
    dz = DisaggEngine(params, cfg, device="cpu", migrate="frozen", **kw)
    out_dz = dz.generate(prompts, max_new_tokens=6)
    assert out_co == out_dz
    for i in range(len(prompts)):
        np.testing.assert_allclose(dz.request_logits[i],
                                   co.request_logits[i], atol=1e-4, rtol=0)
    c = dz.decode[0].counters
    pb = page_bytes(cfg, 8, quantized=True, num_values=16)
    assert c["host_page_solves"] == 0
    assert c["migrated_pages"] == 2 * (32 // 8)
    assert c["migrate_bytes"] == c["migrated_pages"] * pb["frozen"]
    assert c["migrate_fp_equiv_bytes"] == c["migrated_pages"] * pb["fp"]
    if cfg.name.startswith("qwen3"):
        assert c["migrate_fp_equiv_bytes"] >= 5 * c["migrate_bytes"] > 0
    s = dz._summary()
    assert s["migrate_solves"] == len(prompts)
    assert s["migrate_compression"] == pb["fp"] / pb["frozen"]
    # the migrated pages are never queued for a second solve (decode
    # fills no page here: 32 + 6 tokens)
    assert c["freeze_dispatches"] == 0 < co.counters["freeze_dispatches"]
    assert dz.prefills[0].alloc.num_free == dz.prefills[0].num_blocks - 1


def _harvest_at_dispatch(ref):
    """Make the reference's prefill workers harvest in the call that
    dispatches, as the port's do on the CPU (no event to wait for): the
    reference polls jax's async dispatch, so its schedule, and the freeze
    dispatches that follow from it, would depend on timing."""
    for pw in ref.prefills:
        pw.step = lambda now_fn, _step=pw.step: _step(now_fn, block=True)


def test_disagg_frozen_matches_reference_disagg_engine(reduced):
    """Carried weights through both packages' DisaggEngine with frozen
    migration: equal greedy tokens, logits within 1e-3, equal migration
    counters and compression."""
    jcfg, jparams, cfg, params = reduced
    prompts = _prompts(cfg, 1, (20, 13, 16))
    kw = dict(KW, max_seq_len=48, kv_quant="kmeans_ls@16",
              freeze_async=False, freeze_page_budget=16)
    ref = JaxDisaggEngine(jparams, jcfg, migrate="frozen",
                          attn_impl="gather", **kw)
    _harvest_at_dispatch(ref)
    ref_out = ref.generate(prompts, max_new_tokens=6)
    ours = DisaggEngine(params, cfg, device="cpu", migrate="frozen", **kw)
    out = ours.generate(prompts, max_new_tokens=6)
    assert out == ref_out
    for i in range(len(prompts)):
        np.testing.assert_allclose(ours.request_logits[i],
                                   ref.request_logits[i], atol=1e-3, rtol=0)
    keys = ("migrated_seqs", "migrated_pages", "migrate_bytes",
            "migrate_fp_equiv_bytes", "migrate_compression",
            "freeze_dispatches", "host_page_solves")
    theirs, s = ref._summary(), ours._summary()
    assert {k: s[k] for k in keys} == {k: theirs[k] for k in keys}


def test_disagg_frozen_fused_matches_gather(qwen):
    """Frozen-migrated pages are servable by the fused read at once: the
    fused engine (the kernel's plain version on the CPU) gives the gather
    engine's tokens, logits within 1e-3."""
    cfg, params = qwen
    prompts = _prompts(cfg, 4, (10, 10))
    runs = {}
    for impl in ("gather", "fused"):
        eng = DisaggEngine(params, cfg, device="cpu", migrate="frozen",
                           max_slots=2, block_size=8, max_seq_len=32,
                           kv_quant="kmeans_ls@16", record_logits=True,
                           attn_impl=impl, freeze_async=False)
        runs[impl] = (eng, eng.generate(prompts, max_new_tokens=4))
    (g_eng, g_out), (f_eng, f_out) = runs["gather"], runs["fused"]
    assert g_out == f_out
    for i in range(len(prompts)):
        np.testing.assert_allclose(f_eng.request_logits[i],
                                   g_eng.request_logits[i], atol=1e-3,
                                   rtol=0)


def test_frozen_payload_is_harvested_only_once_its_solve_is_ready(qwen):
    """The prefill worker harvests a frozen payload only when is_ready
    covers the solve, stages its codes and frees the pool's blocks."""
    cfg, params = qwen
    from repro_torch.serving import resolve_kv_spec

    pw = PrefillWorker(params, cfg, device="cpu", block_size=8,
                       max_seq_len=32, migrate="frozen",
                       kv_spec=resolve_kv_spec("kmeans_ls@16"))
    assert pw.own_pool.quantized
    req = Request(id=0, prompt=tuple(range(1, 21)), max_new_tokens=2)
    pw.metrics.arrival(0, 0.0, req.prompt_len)
    pw.submit(req)
    (fin,) = pw.step(lambda: 0.0)
    p = fin.payload
    assert p.mode == "frozen" and p.staged and p.solve_event is None
    assert (p.n_full, p.tail_rows) == (2, 4)
    assert p.frozen[0].dtype == torch.uint8 and not p.frozen[0].is_cuda
    assert pw.counters["migrate_solves"] == 1
    assert pw.alloc.num_free == pw.num_blocks - 1


def _slow_card(monkeypatch, polls):
    """A card slower than the host: every payload reads not ready for its
    first ``polls`` polls (on the CPU a payload is ready at once)."""
    from repro_torch.serving import transfer

    seen = {}

    def is_ready(self):
        seen[id(self)] = n = seen.get(id(self), 0) + 1
        return n > polls

    monkeypatch.setattr(transfer.PagePayload, "is_ready", is_ready)


def test_replay_schedule_does_not_depend_on_the_cards_timing(qwen,
                                                               monkeypatch):
    """With a budgeted freeze the step at which a page is quantized
    depends on when each prompt joins the decode batch. On a card slower
    than the host, decode steps run before the next prefill is harvested
    and the logits move; with ``block_prefill`` (the launcher's replays)
    greedy tokens and logits are bitwise those of the CPU's schedule."""
    cfg, params = qwen
    prompts = _prompts(cfg, 5, (16, 16, 16))
    kw = dict(KW, max_slots=3, max_seq_len=40, kv_quant="kmeans_ls@16",
              freeze_async=False, freeze_page_budget=1)

    def run(**extra):
        eng = DisaggEngine(params, cfg, device="cpu", migrate="fp", **kw,
                           **extra)
        return eng, eng.generate(prompts, max_new_tokens=6)

    base, out = run()
    _slow_card(monkeypatch, 3)
    slow, _ = run()
    blocked, blocked_out = run(block_prefill=True)
    same = lambda eng: all(np.array_equal(eng.request_logits[i],
                                          base.request_logits[i])
                           for i in range(len(prompts)))
    assert not same(slow)               # the slow card changes the replay
    assert blocked_out == out and same(blocked)


def test_launcher_replays_block_on_each_prefill(qwen):
    """``_make_engine`` builds a disagg replay (recorded logits) with
    ``block_prefill`` and the served engine without it."""
    from repro_torch.launch import serve

    cfg, params = qwen
    args = serve.parse_args(["--reduced", "--device", "cpu", "--engine",
                             "disagg"])
    assert serve._make_engine(params, cfg, args, kv_quant=None,
                              record_logits=True).block_prefill
    assert not serve._make_engine(params, cfg, args,
                                  kv_quant=None).block_prefill
