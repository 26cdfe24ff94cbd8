"""Overload survival in the port (``repro_torch.serving.overload``, the
decode worker's ``preempt``/``restore``, the engines' shed/defer doors),
held to the reference's ``repro.serving.overload`` on reduced qwen3 (f32,
CPU). Mirrors ``tests/test_overload.py`` (all but its trace-span test,
which waits for the port's tracer) and the tiered-residency and
refcount-under-overload properties of ``tests/test_properties.py``.

Tolerances. The decision functions (``choose_resume``,
``SLOAdmission.decide``/``may_resume``, the windowed p99) answer exactly
as the reference's over a grid of inputs. A forced restore against the
port's own uninterrupted run: identical tokens (the restore lands the
pages bitwise). The port's forced restore against the reference's, on
carried weights: identical tokens and overload counters, equal
``offload_bytes``, logits within atol 1e-3 (the reference's engine bar,
as ``tests/test_torch_serving.py``).
"""
import argparse
import dataclasses
import itertools
from collections import Counter

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import models as jmodels
from repro.configs import get_reduced_config as jax_reduced_config
from repro.obs.stats import Registry as JaxRegistry
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import ContinuousBatchingScheduler as JaxScheduler
from repro.serving import DisaggEngine as JaxDisaggEngine
from repro.serving import DisaggRouter as JaxRouter
from repro.serving import Request as JaxRequest
from repro.serving import SLOAdmission as JaxSLOAdmission
from repro.serving import choose_resume as jax_choose_resume
from repro.serving.scheduler import poisson_trace as jax_poisson_trace
from repro_torch import models
from repro_torch.configs import get_reduced_config
from repro_torch.launch import serve
from repro_torch.obs.stats import Registry
from repro_torch.serving import (BlockAllocator, ContinuousBatchingEngine,
                                 ContinuousBatchingScheduler, DisaggEngine,
                                 DisaggRouter, HostPageStore, PoolExhausted,
                                 Request, ResumeEntry, SLOAdmission,
                                 choose_resume, derive_draft, poisson_trace)

# tiny tensors: one intra-op thread (more make these shapes far slower)
torch.set_num_threads(1)

pytestmark = pytest.mark.serving

KW = dict(max_slots=2, block_size=8, max_seq_len=48,
          kv_quant="kmeans_ls@16", freeze_async=False)


@pytest.fixture(scope="module")
def qwen():
    """Reduced qwen3: the reference's seeded weights and the port's copy."""
    jcfg = jax_reduced_config("qwen3_0_6b")
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_reduced_config("qwen3_0_6b")
    params = models.params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _mk_requests(Req, vocab, n, *, max_new=12, temperature=0.0, top_k=0,
                 seed=7):
    """The reference test's requests (odd ids best_effort) as ``Req``."""
    rng = np.random.default_rng(seed)
    return [Req(id=i, prompt=tuple(int(x) for x in
                                   rng.integers(0, vocab, 12)),
                max_new_tokens=max_new, temperature=temperature,
                top_k=top_k, seed=1000 + i,
                priority="best_effort" if i % 2 else "latency")
            for i in range(n)]


# ------------------------------------------------------- typed exhaustion


def test_pool_exhausted_typed():
    a = BlockAllocator(4)
    a.alloc(2)
    with pytest.raises(PoolExhausted) as ei:
        a.alloc(5)
    assert (ei.value.requested, ei.value.free) == (5, 1)
    assert "5" in str(ei.value) and "1" in str(ei.value)
    with pytest.raises(MemoryError):
        a.alloc(5)


# --------------------------------------------------------- cost model

GRID = list(itertools.product((0, 3), (0, 4), (0, 2400, 2401, 4000),
                              (0, 4000), (False, True)))


@pytest.mark.parametrize("frozen,total,restore,fp,exact", GRID)
def test_choose_resume_matches_the_reference(frozen, total, restore, fp,
                                             exact):
    kw = dict(frozen_pages=frozen, total_pages=total, restore_bytes=restore,
              fp_equiv_bytes=fp, exact_required=exact)
    assert choose_resume(**kw) == jax_choose_resume(**kw)


def test_choose_resume_cost_model():
    """The reference's hard rules: quantized or sampled runs restore;
    a well-compressed payload restores; a full-width one recomputes."""
    kw = dict(total_pages=4, fp_equiv_bytes=4000)
    assert choose_resume(frozen_pages=0, restore_bytes=4000,
                         exact_required=True, **kw) == "restore"
    assert choose_resume(frozen_pages=3, restore_bytes=1000,
                         exact_required=False, **kw) == "restore"
    assert choose_resume(frozen_pages=0, restore_bytes=4000,
                         exact_required=False, **kw) == "recompute"
    assert choose_resume(frozen_pages=0, total_pages=0, restore_bytes=0,
                         fp_equiv_bytes=0, exact_required=False) \
        == "recompute"


# ------------------------------------------------------- SLO admission


class _Metrics:
    def __init__(self, registry):
        self.stats = registry()


def _both_policies(**kw):
    """The port's and the reference's policy, each over its own registry,
    plus a function observing one gap in both."""
    ours, theirs = _Metrics(Registry), _Metrics(JaxRegistry)
    pols = (SLOAdmission(ours, **kw), JaxSLOAdmission(theirs, **kw))

    def observe(v, n=1):
        for m in (ours, theirs):
            h = m.stats.histogram("itl_s")
            for _ in range(n):
                h.observe(v)
    return pols, observe


@pytest.mark.parametrize("gaps", [(), ((0.05, 8),), ((0.001, 8),),
                                  ((0.1, 32), (0.001, 64)),
                                  ((0.001, 20), (0.5, 3)),
                                  ((0.02, 3),), ((0.011, 200),)])
@pytest.mark.parametrize("slo", [None, 0.01])
def test_slo_policy_matches_the_reference_over_a_grid(gaps, slo):
    """decide() at every (tier, occupancy) after each batch of gaps, the
    windowed p99 and may_resume(): the port's answers are the
    reference's."""
    (ours, theirs), observe = _both_policies(itl_slo_s=slo, window=16,
                                             min_samples=4)
    reqs = [(R(id=0, prompt=(1,), max_new_tokens=4, priority=p))
            for p in ("latency", "best_effort")
            for R in (Request, JaxRequest)]
    for v, n in ((None, 0),) + tuple(gaps):
        if v is not None:
            observe(v, n)
        for occ in (0.1, 0.8, 0.9, 0.95, 0.99, 1.0):
            for r_ours, r_ref in (reqs[:2], reqs[2:]):
                assert ours.decide(r_ours, occupancy=occ) \
                    == theirs.decide(r_ref, occupancy=occ)
            for idle in (False, True):
                assert ours.may_resume(occupancy=occ, idle=idle) \
                    == theirs.may_resume(occupancy=occ, idle=idle)
        assert ours.windowed_itl_p99() == theirs.windowed_itl_p99()


def test_slo_admission_decisions():
    (pol, _), observe = _both_policies(itl_slo_s=0.010, occ_defer=0.95,
                                       occ_resume=0.80, min_samples=4)
    lat = Request(id=0, prompt=(1,), max_new_tokens=4, priority="latency")
    be = Request(id=1, prompt=(1,), max_new_tokens=4, priority="best_effort")
    assert pol.decide(be, occupancy=0.5) == "admit"
    assert pol.decide(lat, occupancy=1.0) == "admit"
    assert pol.decide(be, occupancy=0.99) == "defer"
    observe(0.050, 8)
    assert pol.decide(be, occupancy=0.5) == "shed"
    assert pol.decide(lat, occupancy=0.5) == "admit"
    assert not pol.may_resume(occupancy=0.90, idle=False)
    assert pol.may_resume(occupancy=0.70, idle=False)
    assert pol.may_resume(occupancy=1.0, idle=True)
    with pytest.raises(ValueError, match="occ_resume"):
        SLOAdmission(_Metrics(Registry), occ_defer=0.5, occ_resume=0.8)


def test_slo_windowed_not_lifetime():
    """A bad cold-start window washes out once the live window is
    healthy; the lifetime p99 would still shed."""
    (pol, ref), observe = _both_policies(itl_slo_s=0.010, window=16,
                                         min_samples=4)
    be = Request(id=1, prompt=(1,), max_new_tokens=4,
                 priority="best_effort")
    jbe = JaxRequest(id=1, prompt=(1,), max_new_tokens=4,
                     priority="best_effort")
    observe(0.100, 32)
    assert pol.decide(be, occupancy=0.1) == ref.decide(jbe, occupancy=0.1) \
        == "shed"
    observe(0.001, 64)
    assert pol.decide(be, occupancy=0.1) == ref.decide(jbe, occupancy=0.1) \
        == "admit"
    assert pol.metrics.stats.histogram("itl_s").percentile(99) > 0.010


def test_host_page_store_refuses_what_it_cannot_hold():
    from repro_torch.serving import PagePayload

    store = HostPageStore()
    req = Request(id=3, prompt=(1,), max_new_tokens=2)
    p = PagePayload(mode="resident", blocks=[1], n_tokens=8, block_size=8,
                    n_full=1, tail_rows=0)
    with pytest.raises(ValueError, match="staged"):
        store.put(ResumeEntry(req=req, out=[1], generated=1, n_tokens=8,
                              payload=p))
    p.staged, p.nbytes = True, 64
    store.put(ResumeEntry(req=req, out=[1], generated=1, n_tokens=8,
                          payload=p))
    with pytest.raises(ValueError, match="demoted already"):
        store.put(ResumeEntry(req=req, out=[1], generated=1, n_tokens=8,
                              payload=p))
    assert (len(store), store.nbytes, store.pages, 3 in store) == (
        1, 64, 1, True)
    assert store.release(3) is not None and store.release(3) is None


def test_defer_and_retry(qwen):
    """A best_effort arrival against a full pool waits deferred (its
    arrival metered once); once occupancy recedes it rejoins the waiting
    queue behind the FCFS door."""
    _, _, cfg, params = qwen
    eng = ContinuousBatchingEngine(params, cfg, device="cpu", max_slots=2,
                                   block_size=8, max_seq_len=48,
                                   num_blocks=7, admission="slo")
    om, w = eng.overload, eng.worker
    held = w.alloc.alloc(6)
    w.sched.admit_direct(Request(id=9, prompt=(1,), max_new_tokens=2))
    be = Request(id=0, prompt=(1, 2, 3), max_new_tokens=4,
                 priority="best_effort")
    lat = Request(id=1, prompt=(1, 2, 3), max_new_tokens=4)
    assert eng.submit(be, 0.0) is True
    assert list(om.deferred) == [be] and not w.sched.waiting
    assert eng.submit(lat, 0.0) is True
    assert list(w.sched.waiting) == [lat]
    assert om.retry_deferred(w) == 0
    w.alloc.free(held)
    assert om.retry_deferred(w) == 1
    assert list(w.sched.waiting) == [lat, be]
    assert eng.metrics.summary()["deferred"] == 1


# ------------------------------------- fault injection: worst-moment restore


def _forced_offload_outputs(eng, requests, *, at_steps, worker=None):
    """Run ``requests`` on ``eng`` (either package's engine), preempting
    (restore mode) the longest live sequence at each decode step in
    ``at_steps``: the very next decode step reads its pages, so the
    restore has no slack. Returns (outputs, summary)."""
    om = eng.overload
    w = worker if worker is not None else eng.worker
    orig_step = w.step
    fired = set()

    def step(now_fn):
        n = w.counters["decode_steps"]
        if n in at_steps and n not in fired and w.sched.active:
            fired.add(n)
            slot = max(w.sched.active, key=lambda i: (int(w.lens[i]), i))
            st = w.sched.active[slot]
            if not st.done and w.slots[slot].out:
                entry = w.preempt(st, "restore", now_fn())
                om.store.put(entry)
                om.resume.append(entry)
        orig_step(now_fn)

    w.step = step
    summary = eng.run(requests)
    assert fired, "fault injection never fired: trace too short"
    assert len(om.store) == 0 and not om.resume
    return dict(eng.outputs), summary


OVERLOAD_KEYS = ("preemptions", "preempt_offloads", "preempt_recomputes",
                 "offloaded_pages", "offload_bytes", "offload_fp_equiv_bytes",
                 "restored_seqs", "restored_pages", "restore_bytes")


def _agree_with_reference(ours, s, ref, s_ref, n):
    """Tokens, overload counters and bytes equal; logits within 1e-3."""
    assert dict(ours.outputs) == dict(ref.outputs)
    assert {k: s[k] for k in OVERLOAD_KEYS} \
        == {k: s_ref[k] for k in OVERLOAD_KEYS}
    for i in range(n):
        np.testing.assert_allclose(ours.request_logits[i],
                                   ref.request_logits[i], atol=1e-3, rtol=0)


@pytest.mark.parametrize("speculate", [0, 2])
def test_forced_restore_token_identity_colocated(qwen, speculate):
    """Colocated, with and without speculation: a restore at the worst
    moment gives the uninterrupted run's tokens, and the reference's."""
    jcfg, jparams, cfg, params = qwen
    kw = dict(KW, speculate=speculate, record_logits=True)
    golden = ContinuousBatchingEngine(
        params, cfg, device="cpu",
        draft=derive_draft(params, cfg) if speculate else None, **kw)
    golden.run(_mk_requests(Request, cfg.vocab, 3))
    eng = ContinuousBatchingEngine(
        params, cfg, device="cpu", offload_pages=True,
        draft=derive_draft(params, cfg) if speculate else None, **kw)
    outs, s = _forced_offload_outputs(
        eng, _mk_requests(Request, cfg.vocab, 3), at_steps={3, 7})
    assert outs == dict(golden.outputs)
    assert s["preempt_offloads"] == s["restored_seqs"] >= 1
    assert s["offloaded_pages"] == s["restored_pages"]
    assert s["offload_bytes"] == s["restore_bytes"] > 0
    assert s["offload_compression"] > 1.0
    from repro.serving import derive_draft as jax_derive_draft

    ref = JaxEngine(jparams, jcfg, offload_pages=True,
                    draft=jax_derive_draft(jparams, jcfg) if speculate
                    else None, **kw)
    _, s_ref = _forced_offload_outputs(
        ref, _mk_requests(JaxRequest, cfg.vocab, 3), at_steps={3, 7})
    _agree_with_reference(eng, s, ref, s_ref, 3)


def test_forced_restore_token_identity_disagg(qwen):
    """disagg with frozen migration: the restored pages (migrated frozen,
    then demoted and restored) give the colocated run's tokens, and the
    reference's disagg engine's."""
    jcfg, jparams, cfg, params = qwen
    kw = dict(KW, record_logits=True)
    golden = ContinuousBatchingEngine(params, cfg, device="cpu", **kw)
    golden.run(_mk_requests(Request, cfg.vocab, 3))
    eng = DisaggEngine(params, cfg, device="cpu", migrate="frozen",
                       offload_pages=True, **kw)
    outs, s = _forced_offload_outputs(
        eng, _mk_requests(Request, cfg.vocab, 3), at_steps={3, 7},
        worker=eng.decode[0])
    assert outs == dict(golden.outputs)
    assert s["preempt_offloads"] == s["restored_seqs"] >= 1
    ref = JaxDisaggEngine(jparams, jcfg, migrate="frozen",
                          offload_pages=True, **kw)
    # harvest in the dispatching call, as the port does on the CPU: the
    # reference polls jax's async dispatch, so which sequences are live at
    # the forced steps would otherwise depend on timing
    for pw in ref.prefills:
        pw.step = lambda now_fn, _step=pw.step: _step(now_fn, block=True)
    _, s_ref = _forced_offload_outputs(
        ref, _mk_requests(JaxRequest, cfg.vocab, 3), at_steps={3, 7},
        worker=ref.decode[0])
    _agree_with_reference(eng, s, ref, s_ref, 3)


def test_forced_restore_sampled_rng_carries(qwen):
    """A sampled sequence restores with its live Generator: the tokens
    drawn after the stall are the uninterrupted run's, and the
    reference's."""
    jcfg, jparams, cfg, params = qwen
    kw = dict(KW, record_logits=True)
    reqs = lambda R: _mk_requests(R, cfg.vocab, 3, temperature=0.7, top_k=5)
    golden = ContinuousBatchingEngine(params, cfg, device="cpu", **kw)
    golden.run(reqs(Request))
    eng = ContinuousBatchingEngine(params, cfg, device="cpu",
                                   offload_pages=True, **kw)
    outs, s = _forced_offload_outputs(eng, reqs(Request), at_steps={4})
    assert outs == dict(golden.outputs)
    ref = JaxEngine(jparams, jcfg, offload_pages=True, **kw)
    _, s_ref = _forced_offload_outputs(ref, reqs(JaxRequest), at_steps={4})
    _agree_with_reference(eng, s, ref, s_ref, 3)


# ------------------------------------- retirement while offloaded (leaks)


def test_retire_while_offloaded_drains_host_tier(qwen):
    """A request cancelled while its pages sit in the host tier is
    retired: its store entry and resume place go, and the pool is whole
    at the end."""
    _, _, cfg, params = qwen
    eng = ContinuousBatchingEngine(params, cfg, device="cpu",
                                   offload_pages=True, **KW)
    om, w = eng.overload, eng.worker
    retired = []
    orig_step = w.step

    def step(now_fn):
        if w.counters["decode_steps"] == 3 and w.sched.active and not retired:
            slot = max(w.sched.active, key=lambda i: (int(w.lens[i]), i))
            st = w.sched.active[slot]
            if not st.done and w.slots[slot].out:
                entry = w.preempt(st, "restore", now_fn())
                om.store.put(entry)
                om.resume.append(entry)
                assert len(om.store) == 1 and len(om.resume) == 1
                assert om.retire(st.req.id) is entry
                assert om.retire(st.req.id) is None
                retired.append(st.req.id)
        orig_step(now_fn)

    w.step = step
    eng.run(_mk_requests(Request, cfg.vocab, 3))
    assert retired, "fault injection never fired"
    assert len(om.store) == 0 and not om.resume and not om.deferred
    assert om.store.pages == 0
    assert w.alloc.num_free == w.num_blocks - 1
    assert set(eng.outputs) == {0, 1, 2} - set(retired)


def test_preempt_refuses_a_bad_mode_or_a_finished_sequence(qwen):
    _, _, cfg, params = qwen
    eng = ContinuousBatchingEngine(params, cfg, device="cpu", **KW)
    w = eng.worker
    st = w.sched.admit_direct(Request(id=0, prompt=(1, 2), max_new_tokens=2))
    with pytest.raises(ValueError, match="restore or recompute"):
        w.preempt(st, "drop", 0.0)
    with pytest.raises(ValueError, match="not a live sequence"):
        w.preempt(st, "restore", 0.0)


# ---------------------------------------- preemption visibility at attach


def test_just_attached_victim_visible_to_preemption(qwen):
    """The LRU signal is seeded at attach: a best_effort sequence that has
    decoded nothing yet is visible to ``pick_victim`` at once."""
    _, _, cfg, params = qwen
    kw = dict(KW, max_slots=1)
    reqs = lambda: [
        Request(id=0, prompt=tuple(range(1, 13)), max_new_tokens=8,
                priority="best_effort"),
        Request(id=1, prompt=tuple(range(20, 32)), max_new_tokens=8)]
    golden = ContinuousBatchingEngine(params, cfg, device="cpu", **kw)
    golden.run(reqs())
    eng = ContinuousBatchingEngine(params, cfg, device="cpu",
                                   offload_pages=True, preempt=True, **kw)
    om, w = eng.overload, eng.worker
    seen = []
    orig_attach = w.attach

    def spy_attach(st, fin, now):
        orig_attach(st, fin, now)
        if st.req.priority == "best_effort" and not st.done:
            v = om.pick_victim(w)
            seen.append(None if v is None else v.req.id)

    w.attach = spy_attach
    s = eng.run(reqs())
    assert seen == [0], "just-attached best_effort victim was invisible"
    assert s["preemptions"] >= 1
    assert dict(eng.outputs) == dict(golden.outputs)


def test_mid_chunk_sequence_is_never_a_victim(qwen):
    """A sequence still chunking its prompt holds a slot and pages but no
    output: pick_victim passes it over until it attaches."""
    _, _, cfg, params = qwen
    eng = ContinuousBatchingEngine(params, cfg, device="cpu", max_slots=1,
                                   block_size=8, max_seq_len=48,
                                   prefill_chunk=4, preempt=True)
    om, w = eng.overload, eng.worker
    be = Request(id=0, prompt=tuple(range(1, 13)), max_new_tokens=4,
                 priority="best_effort")
    assert w.submit(be, 0.0)
    (st,) = w.sched.schedule(w.alloc.num_free)
    state = eng.prefill.start_chunked(be, lambda: 0.0)
    w.sched.stage(st)
    assert w.submit(Request(id=1, prompt=(5,) * 12, max_new_tokens=4), 0.0)
    assert om.pick_victim(w) is None
    while (fin := eng.prefill.advance_chunk(state, lambda: 0.0)) is None:
        pass
    w.sched.activate(st)
    w.attach(st, fin, 0.0)
    assert om.pick_victim(w) is st


# ----------------------------------------- preempt-and-requeue, end to end


@pytest.mark.parametrize("offload", [True, False])
def test_preempt_under_pressure_completes_identically(qwen, offload):
    """A 2x-oversubscribed pool with preemption: every request completes
    with the uncontended run's tokens, the resume path follows the cost
    model (quantized: restore; fp greedy without the host tier:
    recompute), and the counters equal the reference engine's."""
    jcfg, jparams, cfg, params = qwen
    kv = "kmeans_ls@16" if offload else None
    kw = dict(KW, kv_quant=kv)
    golden = ContinuousBatchingEngine(params, cfg, device="cpu", **kw)
    golden.run(_mk_requests(Request, cfg.vocab, 4))
    eng = ContinuousBatchingEngine(params, cfg, device="cpu", num_blocks=8,
                                   offload_pages=offload, preempt=True, **kw)
    s = eng.run(_mk_requests(Request, cfg.vocab, 4))
    assert dict(eng.outputs) == dict(golden.outputs)
    assert s["preemptions"] >= 1
    if offload:
        assert s["preempt_recomputes"] == 0
        assert s["preempt_offloads"] == s["restored_seqs"] >= 1
    else:
        assert s["preempt_offloads"] == 0
        assert s["preempt_recomputes"] >= 1
    ref = JaxEngine(jparams, jcfg, num_blocks=8, offload_pages=offload,
                    preempt=True, **kw)
    s_ref = ref.run(_mk_requests(JaxRequest, cfg.vocab, 4))
    assert dict(ref.outputs) == dict(eng.outputs)
    assert {k: s[k] for k in OVERLOAD_KEYS} \
        == {k: s_ref[k] for k in OVERLOAD_KEYS}


@pytest.mark.parametrize("Sched,Req", [(ContinuousBatchingScheduler, Request),
                                       (JaxScheduler, JaxRequest)])
def test_preempted_requeue_ahead_of_fcfs(Sched, Req):
    sched = Sched(max_slots=1, block_size=8)
    a = Req(id=0, prompt=(1,) * 8, max_new_tokens=8)
    b = Req(id=1, prompt=(1,) * 8, max_new_tokens=8)
    sched.submit(a)
    sched.preempted.append(b)
    assert sched.has_work
    assert [st.req.id for st in sched.schedule(free_blocks=64)] == [1]


@pytest.mark.parametrize("Router,Req", [(DisaggRouter, Request),
                                        (JaxRouter, JaxRequest)])
def test_router_sends_recompute_requeues_to_prefill_first(Router, Req):
    class _Prefill:
        worker_id, load = 0, 0
        got = []

        def can_accept(self):
            return True

        def submit(self, req):
            self.got.append(req.id)

    router = Router()
    pw = _Prefill()
    router.submit(Req(id=0, prompt=(1,) * 4, max_new_tokens=4))
    router.preempted.append(Req(id=1, prompt=(1,) * 4, max_new_tokens=4))
    assert router.has_work
    router.route_prefill([pw])
    assert pw.got == [1, 0] and not router.has_work


def test_trace_tiers_are_the_reference_trace_tiers():
    kw = dict(vocab=499, prompt_len=12, max_new_tokens=5, seed=0)
    for frac in (0.0, 0.5, 1.0):
        ours = poisson_trace(8, 8.0, best_effort_frac=frac, **kw)
        ref = jax_poisson_trace(8, 8.0, best_effort_frac=frac, **kw)
        assert [(r.prompt, r.arrival_time, r.priority) for r in ours] == [
            (r.prompt, r.arrival_time, r.priority) for r in ref]
    tiers = [r.priority for r in poisson_trace(8, 8.0, best_effort_frac=0.5,
                                               **kw)]
    assert [i for i, t in enumerate(tiers) if t == "best_effort"] \
        == [3, 5, 7]


# ----------------------------------------------- admission reason counters


def test_admission_reason_counters(qwen):
    _, _, cfg, params = qwen
    eng = ContinuousBatchingEngine(params, cfg, device="cpu", max_slots=2,
                                   block_size=8, max_seq_len=48, max_queue=1)
    assert not eng.submit(Request(id=0, prompt=(1,) * 40,
                                  max_new_tokens=40), 0.0)
    assert eng.submit(Request(id=1, prompt=(1, 2), max_new_tokens=2), 0.0)
    assert not eng.submit(Request(id=2, prompt=(1, 2), max_new_tokens=2),
                          0.0)
    snap = eng.metrics.snapshot()
    assert snap["rejected_pool_full"] == 1
    assert snap["rejected_queue_full"] == 1


@pytest.mark.parametrize("disagg", [False, True])
def test_summary_keys_absent_without_overload(qwen, disagg):
    """Runs that never shed, deferred or preempted keep the summary's key
    set: no admission reason and no offload_compression key."""
    _, _, cfg, params = qwen
    Engine = DisaggEngine if disagg else ContinuousBatchingEngine
    eng = Engine(params, cfg, device="cpu", max_slots=2, block_size=8,
                 max_seq_len=48)
    assert eng.overload is None
    s = eng.run(_mk_requests(Request, cfg.vocab, 2))
    for k in ("rejected_queue_full", "rejected_pool_full", "shed_slo",
              "deferred", "offload_compression"):
        assert k not in s


@pytest.mark.parametrize("disagg", [False, True])
def test_shed_slo_end_to_end(qwen, disagg):
    """With an impossible inter-token SLO, later best_effort arrivals shed
    while every latency request completes, on both compositions."""
    _, _, cfg, params = qwen
    Engine = DisaggEngine if disagg else ContinuousBatchingEngine
    eng = Engine(params, cfg, device="cpu", max_slots=2, block_size=8,
                 max_seq_len=48, admission="slo", itl_slo_s=1e-9)
    reqs = [dataclasses.replace(r, arrival_time=0.05 * i)
            for i, r in enumerate(_mk_requests(Request, cfg.vocab, 8))]
    s = eng.run(reqs)
    shed = s.get("shed_slo", 0)
    assert shed >= 1 and s["rejected"] == shed
    assert {r.id for r in reqs if r.priority == "latency"} <= set(eng.outputs)


# ------------------------------------ tiered residency (host offload)


def assert_pool_partition(worker):
    """The free list and the refcounted live tables partition the pool
    (a page in N tables has rc N), and the freeze bookkeeping names only
    live pages; refcounts never rise along a table."""
    free, used = set(worker.alloc._free), set(worker.alloc._used)
    live = Counter()
    for s in worker.slots:
        live.update(int(b) for b in s.blocks)
    assert dict(live) == dict(worker.alloc._rc)
    assert set(live) == used and not (free & used)
    assert free | used == set(range(1, worker.num_blocks))
    assert worker._frozen_pages <= used
    assert set(worker._freeze_bids) <= used
    for s in worker.slots:
        rcs = [worker.alloc.refcount(int(b)) for b in s.blocks]
        assert all(x >= y for x, y in zip(rcs, rcs[1:])), rcs


def assert_tiered_partition(worker, om):
    """The device partition holds, and every demoted sequence sits whole
    in the host tier: no page of it on the card, its payload staged, its
    resume entry queued."""
    assert_pool_partition(worker)
    active = {st.req.id for st in worker.sched.active.values()}
    stored = {e.req.id for e in om.store.entries()}
    assert not stored & active, "a sequence resident in both tiers"
    for e in om.store.entries():
        assert e.payload is not None and e.payload.staged
        assert e.payload.n_pages >= 1 and len(e.out) == e.generated
    assert {e.req.id for e in om.resume} == stored
    assert om.store.pages == sum(e.payload.n_pages
                                 for e in om.store.entries())


def _check_tiered_conservation(qwen, reqs, speculate):
    """An overloaded engine (a pool of half the demand) with preempt and
    offload: the two-tier partition holds at every step, preemptions
    land between verify windows and host entries outlive other
    sequences; the run drains both tiers and never recomputes."""
    _, _, cfg, params = qwen
    eng = ContinuousBatchingEngine(
        params, cfg, device="cpu", max_slots=2, block_size=8,
        max_seq_len=48, kv_quant="kmeans_ls@16", freeze_page_budget=1,
        num_blocks=8, offload_pages=True, preempt=True, speculate=speculate,
        draft=derive_draft(params, cfg) if speculate else None)
    w, om = eng.worker, eng.overload
    orig_step = w.step
    outlived = [False]

    def checked_step(now_fn):
        orig_step(now_fn)
        assert_tiered_partition(w, om)
        if len(om.store) and eng.outputs:
            outlived[0] = True

    w.step = checked_step
    rng = np.random.default_rng(0)
    requests = [Request(id=i,
                        prompt=tuple(rng.integers(0, cfg.vocab, p).tolist()),
                        max_new_tokens=n,
                        priority="best_effort" if i % 2 else "latency")
                for i, (p, n) in enumerate(reqs)]
    s = eng.run(requests)
    assert_tiered_partition(w, om)
    assert sorted(eng.outputs) == list(range(len(reqs)))
    assert w.alloc.num_free == w.num_blocks - 1
    assert len(om.store) == 0 and not om.resume and not om.deferred
    assert not w._pending_freezes and not w._freeze_bids
    assert s["preempt_recomputes"] == 0
    return s["preemptions"], outlived[0]


def test_tiered_residency_conservation_seeded_corpus(qwen):
    rng = np.random.default_rng(5)
    preempted = outlived = 0
    for speculate in (0, 2):
        reqs = [(int(rng.integers(4, 21)), int(rng.integers(4, 9)))
                for _ in range(4)]
        p, o = _check_tiered_conservation(qwen, reqs, speculate)
        preempted += p
        outlived += o
    assert preempted >= 1 and outlived >= 1


@settings(max_examples=4, deadline=None, derandomize=True)
@given(st.lists(st.tuples(st.integers(4, 20), st.integers(4, 8)),
                min_size=3, max_size=5),
       st.sampled_from([0, 2]))
def test_tiered_residency_conservation_property(qwen, reqs, speculate):
    _check_tiered_conservation(qwen, reqs, speculate)


def _check_refcount_conservation(qwen, shapes, speculate):
    """Prefix sharing under overload: victims drop references to shared
    pages instead of demoting them, with rollback and async installs
    between; the partition holds at every step and pool, host tier and
    prefix index drain to empty."""
    _, _, cfg, params = qwen
    eng = ContinuousBatchingEngine(
        params, cfg, device="cpu", max_slots=2, block_size=8,
        max_seq_len=48, kv_quant="kmeans_ls@16", freeze_page_budget=2,
        num_blocks=10, offload_pages=True, preempt=True, prefix_cache=True,
        speculate=speculate,
        draft=derive_draft(params, cfg) if speculate else None)
    w, om = eng.worker, eng.overload
    orig_step = w.step

    def checked_step(now_fn):
        orig_step(now_fn)
        assert_pool_partition(w)

    w.step = checked_step
    rng = np.random.default_rng(0)
    common = tuple(int(x) for x in rng.integers(0, cfg.vocab, 16))
    requests = [Request(id=i, prompt=common + tuple(
        int(x) for x in rng.integers(0, cfg.vocab, extra)),
        max_new_tokens=gen, priority="best_effort" if i % 2 else "latency")
        for i, (extra, gen) in enumerate(shapes)]
    s = eng.run(requests)
    assert_pool_partition(w)
    assert sorted(eng.outputs) == list(range(len(requests)))
    assert w.alloc.num_free == w.num_blocks - 1
    assert len(om.store) == 0 and not om.resume and not om.deferred
    assert not w._pending_freezes and not w._freeze_bids
    assert len(w.prefix) == 0
    return s


def test_refcount_conservation_seeded_corpus(qwen):
    rng = np.random.default_rng(9)
    hits = preempted = 0
    for speculate in (0, 2):
        shapes = [(int(rng.integers(2, 9)), int(rng.integers(4, 13)))
                  for _ in range(4)]
        s = _check_refcount_conservation(qwen, shapes, speculate)
        hits += s["prefix_hits"]
        preempted += s["preemptions"]
    assert hits >= 1, "no prefill ever spliced shared pages"
    assert preempted >= 1, "no victim ever dropped refs under pressure"


@settings(max_examples=4, deadline=None, derandomize=True)
@given(st.lists(st.tuples(st.integers(2, 8), st.integers(4, 12)),
                min_size=3, max_size=4),
       st.sampled_from([0, 2]))
def test_refcount_conservation_property(qwen, shapes, speculate):
    _check_refcount_conservation(qwen, shapes, speculate)


# ------------------------------------------------- the launcher's checks


@pytest.mark.parametrize("argv,msg", [
    (["--engine", "static", "--preempt"], "--offload-pages/--preempt"),
    (["--engine", "static", "--offload-pages"], "--offload-pages/--preempt"),
    (["--engine", "static", "--admission", "slo"], "--admission slo"),
    (["--engine", "disagg", "--migrate", "frozen"], "--kv-quant"),
    (["--best-effort-frac", "1.5"], "--best-effort-frac"),
    (["--admission", "slo", "--itl-slo", "0"], "--itl-slo"),
])
def test_launcher_refuses_bad_overload_and_migration_flags(argv, msg,
                                                           capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(argv)
    assert msg in capsys.readouterr().err


def test_launcher_takes_the_overload_and_frozen_flags():
    args = serve.parse_args([
        "--engine", "disagg", "--migrate", "frozen", "--kv-quant",
        "kmeans_ls@16", "--offload-pages", "--preempt", "--admission", "slo",
        "--itl-slo", "0.05", "--priority", "best_effort",
        "--best-effort-frac", "0.25"])
    assert (args.migrate, args.offload_pages, args.preempt, args.admission,
            args.itl_slo, args.priority, args.best_effort_frac) == (
        "frozen", True, True, "slo", 0.05, "best_effort", 0.25)
    a = argparse.Namespace(**vars(serve.parse_args([])))
    assert (a.offload_pages, a.preempt, a.admission, a.itl_slo, a.priority,
            a.best_effort_frac) == (False, False, "fcfs", None, "latency",
                                    0.0)
