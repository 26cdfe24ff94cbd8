"""Traces of the port's serving engines (``repro_torch.obs.Tracer`` and
``MetricsExporter`` on ``ContinuousBatchingEngine``/``DisaggEngine``), on
the reduced qwen3 with the reference's seeded weights carried across and
the reference test's geometry (``tests/test_obs.py``): its five engine
tests, ``tests/test_overload.py``'s offload-span reconciliation, the
freeze-bid span check of ``tests/test_properties.py``'s chunked-prefill
differential, the launcher's ``--trace-out``/``--metrics-jsonl``, and one
parity run against the reference's engine.

Determinism. A seeded ``FakeClock`` trace is byte-identical across two
runs with synchronous freezes: an asynchronous freeze installs when its
event reports ready, so on the card the iteration of an install depends on
the clock (on the CPU a solve is complete when dispatched). Traces are
compared by bytes only here; on the card by counts.

Parity: one seeded colocated run with synchronous freezes and chunked
prefill in both packages has the same tracks, the same decode_step, flush,
prefill_chunk and install counts, the same page_freeze begins and the same
terminal-state counts. The counts depend on the schedule, which greedy
requests without an eos token fix whatever tokens are drawn.
"""
import json
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_reduced_config as jax_reduced_config
from repro.obs import FakeClock as JaxFakeClock
from repro.obs import Tracer as JaxTracer
from repro.obs import tracks_of as jax_tracks_of
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving.scheduler import make_requests as jax_make_requests
from repro_torch import models
from repro_torch.configs import get_reduced_config
from repro_torch.launch import serve
from repro_torch.obs import (FakeClock, MetricsExporter, Tracer,
                             count_events, prometheus_text, select_events,
                             tracks_of)
from repro_torch.serving import (ContinuousBatchingEngine, DisaggEngine,
                                 Request, derive_draft)
from repro_torch.serving.scheduler import make_requests

torch.set_num_threads(1)

pytestmark = pytest.mark.serving

PROMPT_SEED = 42
N_REQ, PROMPT_LEN, GEN = 3, 12, 8
GEOM = dict(device="cpu", max_slots=2, block_size=8, max_seq_len=48)
FREEZE_STATES = {"installed", "dropped", "rolled_back", "offloaded"}


@pytest.fixture(scope="module")
def model():
    """Reduced qwen3: the reference's seeded weights, the port's copy, and
    the reference test's prompts."""
    jcfg = jax_reduced_config("qwen3_0_6b")
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_reduced_config("qwen3_0_6b")
    params = models.params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    rng = np.random.default_rng(PROMPT_SEED)
    prompts = [rng.integers(0, cfg.vocab, PROMPT_LEN).tolist()
               for _ in range(N_REQ)]
    return jcfg, jparams, cfg, params, prompts


def _freeze_span_states(events):
    """(begin count, {span id -> terminal state}) of page_freeze spans; a
    span ending twice fails."""
    begins = select_events(events, name="page_freeze", ph="b")
    states = {}
    for e in select_events(events, name="page_freeze", ph="e"):
        assert e["id"] not in states, f"span {e['id']} ended twice"
        states[e["id"]] = e["args"]["state"]
    return len(begins), states


def test_colocated_trace_byte_identical(model, tmp_path):
    *_, cfg, params, prompts = model

    def one(tag):
        tr = Tracer(clock=FakeClock())
        eng = ContinuousBatchingEngine(
            params, cfg, kv_quant="kmeans_ls@16", freeze_async=False,
            tracer=tr, **GEOM)
        s = eng.run(make_requests(prompts, GEN))
        path = tmp_path / f"{tag}.json"
        tr.write(str(path))
        return tr, s, path.read_bytes()

    tr, s, raw1 = one("a")
    _, _, raw2 = one("b")
    assert raw1 == raw2, "seeded colocated trace is not byte-deterministic"
    assert json.loads(raw1)["traceEvents"]
    assert count_events(tr.events, name="decode_step", ph="X") \
        == s["decode_steps"]
    assert count_events(tr.events, name="flush", ph="X") \
        == s["freeze_dispatches"]
    nb, states = _freeze_span_states(tr.events)
    assert nb == len(states) > 0, "a freeze span never ended"
    assert set(states.values()) <= {"installed", "dropped", "rolled_back"}
    # the decode step's phases, and the router's admissions
    for name in ("dispatch", "sync", "commit"):
        assert count_events(tr.events, name=name, ph="X") >= s["decode_steps"]
    assert count_events(tr.events, name="admit", ph="i") == N_REQ


def test_disagg_trace_byte_identical(model, tmp_path):
    *_, cfg, params, prompts = model

    def one(tag):
        tr = Tracer(clock=FakeClock())
        eng = DisaggEngine(
            params, cfg, prefill_workers=1, decode_workers=1,
            migrate="frozen", kv_quant="kmeans_ls@16", freeze_async=False,
            tracer=tr, **GEOM)
        eng.run(make_requests(prompts[:1], GEN))
        path = tmp_path / f"{tag}.json"
        tr.write(str(path))
        return tr, path.read_bytes()

    tr, raw1 = one("a")
    _, raw2 = one("b")
    assert raw1 == raw2, "seeded disagg trace is not byte-deterministic"
    assert {"router", "prefill/w0", "decode/w0", "transfer"} \
        <= set(tracks_of(tr))
    # frozen migration crosses as codes + codebooks
    ex = select_events(tr.events, name="extract", ph="X")
    assert ex and all(e["args"]["mode"] == "frozen" for e in ex)
    (th,) = select_events(tr.events, name="to_host", ph="X")
    assert th["args"]["bytes"] < th["args"]["fp_equiv_bytes"]
    assert count_events(tr.events, name="prefill", ph="b") \
        == count_events(tr.events, name="prefill", ph="e") == 1


def test_freeze_spans_terminal_by_drain(model):
    """Async freezing: every page_freeze span ends in one terminal state
    by drain, and the install instants match the counter."""
    *_, cfg, params, prompts = model
    tr = Tracer(clock=FakeClock())
    eng = ContinuousBatchingEngine(
        params, cfg, kv_quant="kmeans_ls@16", freeze_async=True, tracer=tr,
        **GEOM)
    s = eng.run(make_requests(prompts, GEN))
    nb, states = _freeze_span_states(tr.events)
    assert nb > 0, "the run froze nothing"
    assert nb == len(states)
    assert set(states.values()) <= {"installed", "dropped", "rolled_back"}
    assert count_events(tr.events, name="flush", ph="X") \
        == s["freeze_dispatches"]
    assert count_events(tr.events, name="install", ph="i") \
        == s["freeze_installs"]
    assert count_events(tr.events, name="page_freeze", ph="n") <= nb


def test_six_component_spec_disagg_trace(model, tmp_path):
    """Disagg + speculative + frozen migration: all six component tracks,
    every speculative and freeze counter reconciled with the trace."""
    *_, cfg, params, prompts = model
    tr = Tracer(clock=FakeClock())
    eng = DisaggEngine(
        params, cfg, prefill_workers=1, decode_workers=1, migrate="frozen",
        kv_quant="kmeans_ls@16", speculate=2,
        draft=derive_draft(params, cfg), tracer=tr, **GEOM)
    s = eng.run(make_requests(prompts, GEN))
    assert s["completed"] == N_REQ
    got = set(tracks_of(tr))
    assert {"router", "prefill/w0", "decode/w0", "freeze/w0", "spec/w0",
            "transfer", "draft/w0"} <= got
    assert count_events(tr.events, name="accept", ph="i") == s["spec_steps"]
    assert count_events(tr.events, name="rollback", ph="i") \
        == s["spec_rollbacks"]
    assert count_events(tr.events, name="decode_step", ph="X") \
        == s["decode_steps"]
    assert count_events(tr.events, name="flush", ph="X") \
        == s["freeze_dispatches"]
    nb, states = _freeze_span_states(tr.events)
    assert nb == len(states)
    assert set(states.values()) <= {"installed", "dropped", "rolled_back"}
    path = tmp_path / "trace.json"
    tr.write(str(path))
    d = json.load(open(path))
    assert {e["args"]["name"] for e in d["traceEvents"]
            if e["ph"] == "M" and e["name"] == "thread_name"} == got


def test_engine_exporter_jsonl(model, tmp_path):
    """An exporter on the run loop lands strict-JSON lines with the live
    totals, and the roofline gauges reach the registry."""
    *_, cfg, params, prompts = model
    path = str(tmp_path / "m.jsonl")
    exp = MetricsExporter(path, interval_s=0.0)       # emit every step
    eng = ContinuousBatchingEngine(
        params, cfg, kv_quant="kmeans_ls@16", exporter=exp, **GEOM)
    eng.run(make_requests(prompts, GEN))
    exp.close(eng.metrics)
    rows = [json.loads(ln) for ln in open(path)]
    assert len(rows) >= 2
    assert rows[-1]["completed"] == N_REQ
    assert rows[-1]["gen_tokens"] == N_REQ * GEN
    assert "hbm_bytes_per_token" in eng.metrics.stats
    assert eng.metrics.stats.gauge("hbm_bytes_per_token").n > 0
    assert eng.metrics.stats.gauge("t_memory_s").n > 0
    prometheus_text(eng.metrics.snapshot())


def test_tracing_changes_no_token(model):
    *_, cfg, params, prompts = model
    outs = []
    for tr in (None, Tracer(clock=FakeClock())):
        eng = ContinuousBatchingEngine(
            params, cfg, kv_quant="kmeans_ls@16", freeze_async=False,
            prefill_chunk=5, tracer=tr, **GEOM)
        outs.append(eng.generate(prompts, GEN))
    assert outs[0] == outs[1]


def _mk_requests(vocab, n, *, max_new=12, seed=7):
    """``tests/test_overload.py``'s requests (odd ids best_effort)."""
    rng = np.random.default_rng(seed)
    return [Request(id=i, prompt=tuple(int(x) for x in
                                       rng.integers(0, vocab, 12)),
                    max_new_tokens=max_new, seed=1000 + i,
                    priority="best_effort" if i % 2 else "latency")
            for i in range(n)]


def test_offload_spans_reconcile(model):
    """Every offloaded page opens a ``page_offload`` span and every restore
    ends it ``restored``; the victim's open ``page_freeze`` spans end
    ``offloaded``; the preempt and restore instants equal the counters."""
    *_, cfg, params, _ = model
    tr = Tracer(clock=FakeClock())
    # a budget of 1 page a step keeps freezes queued across steps, so a
    # preemption catches open page_freeze spans
    eng = ContinuousBatchingEngine(
        params, cfg, num_blocks=8, offload_pages=True, preempt=True,
        kv_quant="kmeans_ls@16", freeze_async=False, freeze_page_budget=1,
        tracer=tr, **GEOM)
    s = eng.run(_mk_requests(cfg.vocab, 4))
    assert s["preempt_offloads"] >= 1
    b = count_events(tr.events, name="page_offload", ph="b")
    e = count_events(tr.events, name="page_offload", ph="e")
    assert b == e == s["offloaded_pages"] == s["restored_pages"]
    ends = select_events(tr.events, name="page_offload", ph="e")
    assert all(ev["args"]["state"] == "restored" for ev in ends)
    nb, states = _freeze_span_states(tr.events)
    assert nb == len(states)
    assert "offloaded" in states.values()
    assert set(states.values()) <= FREEZE_STATES
    assert count_events(tr.events, name="preempt", ph="i") \
        == s["preemptions"]
    assert count_events(tr.events, name="restore", ph="i") \
        == s["restored_seqs"]
    assert count_events(tr.events, name="to_host", ph="X") \
        == s["preempt_offloads"]


@pytest.mark.parametrize("plens,chunk,kv_quant", [
    ((21, 13, 17), 5, None), ((21, 13, 17), 5, "kmeans_ls@16"),
    ((16, 9), 8, "kmeans_ls@16")])
def test_chunked_prefill_bids_the_same_pages(model, plens, chunk, kv_quant):
    """Chunked vs whole-prompt prefill (chunks interleaving live decodes,
    ``max_slots`` < prompts): the same tokens, and the same freeze bids,
    one page_freeze span a queued page, at attach in both modes."""
    *_, cfg, params, _ = model
    gen = 6 if len(plens) == 3 else 4
    rng = np.random.default_rng(1000 * chunk + sum(plens) + gen)
    prompts = [rng.integers(0, cfg.vocab, p).tolist() for p in plens]
    outs, engines, tracers = [], [], []
    for pc in (None, chunk):
        tr = Tracer()
        eng = ContinuousBatchingEngine(
            params, cfg, device="cpu", max_slots=2, block_size=8,
            max_seq_len=64, kv_quant=kv_quant, freeze_async=False,
            prefill_chunk=pc, tracer=tr)
        outs.append(eng.generate(prompts, max_new_tokens=gen))
        engines.append(eng)
        tracers.append(tr)
    assert outs[0] == outs[1]
    bids = [count_events(tr.events, name="page_freeze", ph="b")
            for tr in tracers]
    assert bids[0] == bids[1]
    assert (bids[0] > 0) == (kv_quant is not None)
    want = sum(-(-(-(-p // 8) * 8) // chunk) for p in plens)
    assert engines[1].prefill.counters["prefill_chunks"] == want
    assert engines[0].prefill.counters["prefill_chunks"] == 0
    assert count_events(tracers[1].events, name="prefill_chunk",
                        ph="X") == want


def _terminal_states(events):
    return Counter(e["args"]["state"] for e in events
                   if e.get("name") == "page_freeze" and e["ph"] == "e")


def test_colocated_trace_counts_equal_the_reference(model):
    """One seeded colocated run (synchronous freezes, chunked prefill) in
    both packages: the same tracks and the same span counts."""
    jcfg, jparams, cfg, params, prompts = model
    kw = dict(max_slots=2, block_size=8, max_seq_len=48,
              kv_quant="kmeans_ls@16", freeze_async=False, prefill_chunk=5)
    jtr = JaxTracer(clock=JaxFakeClock())
    js = JaxEngine(jparams, jcfg, tracer=jtr, **kw).run(
        jax_make_requests(prompts, GEN))
    tr = Tracer(clock=FakeClock())
    s = ContinuousBatchingEngine(params, cfg, device="cpu", tracer=tr,
                                 **kw).run(make_requests(prompts, GEN))
    assert set(tracks_of(tr)) == set(jax_tracks_of(jtr))
    for name, ph in (("decode_step", "X"), ("flush", "X"),
                     ("prefill_chunk", "X"), ("install", "i"),
                     ("page_freeze", "b"), ("page_freeze", "n"),
                     ("admit", "i"), ("finish", "i")):
        assert count_events(tr.events, name=name, ph=ph) \
            == count_events(jtr.events, name=name, ph=ph), (name, ph)
    assert _terminal_states(tr.events) == _terminal_states(jtr.events)
    for k in ("decode_steps", "freeze_dispatches", "prefill_chunks"):
        assert s[k] == js[k], k


def test_launcher_traces_exports_and_reconciles(tmp_path, capsys):
    """``--trace-out`` and ``--metrics-jsonl`` through the entry point:
    the trace reconciles, the JSONL lines load as strict JSON with the
    final totals, the Prometheus file lands beside them."""
    trace, jsonl = tmp_path / "t.json", tmp_path / "m.jsonl"
    s = serve.main(["--reduced", "--device", "cpu", "--kv-quant",
                    "kmeans_ls@16", "--prefill-chunk", "16",
                    "--num-requests", "2", "--prompt-len", "24", "--gen",
                    "6", "--request-rate", "1000", "--trace-out",
                    str(trace), "--metrics-jsonl", str(jsonl),
                    "--metrics-interval", "0"])
    out = capsys.readouterr().out
    assert "-> reconciled" in out
    d = json.loads(trace.read_text())
    assert {"router", "decode/w0", "freeze/w0", "prefill/w0"} <= {
        e["args"]["name"] for e in d["traceEvents"]
        if e["ph"] == "M" and e["name"] == "thread_name"}
    rows = [json.loads(ln, parse_constant=lambda c: pytest.fail(c))
            for ln in jsonl.read_text().splitlines()]
    assert len(rows) >= 2
    assert rows[-1]["completed"] == 2 and rows[-1]["gen_tokens"] == 12
    assert rows[-1]["hbm_bytes_per_token"]["n"] > 0
    assert "repro_completed 2" in (tmp_path / "m.jsonl.prom").read_text()
    assert s["completed"] == 2


def test_reconciliation_fails_on_a_count_that_differs(capsys):
    tr = Tracer(clock=FakeClock())
    tr.complete("decode/w0", "decode_step", tr.now())
    tr.async_begin("freeze/w0", "page_freeze", 1, page=3, slot=0)
    tr.async_end("freeze/w0", "page_freeze", 1, state="installed", page=3)
    assert serve._trace_reconcile(tr, {"decode_steps": 1}, 0)
    assert "reconciled" in capsys.readouterr().out
    assert not serve._trace_reconcile(tr, {"decode_steps": 2}, 0)
    assert not serve._trace_reconcile(
        tr, {"decode_steps": 1, "spec_steps": 1}, 2)
    tr.async_begin("freeze/w0", "page_offload", 2, rid=0, page_pos=0)
    assert not serve._trace_reconcile(
        tr, {"decode_steps": 1, "offloaded_pages": 1, "restored_pages": 1},
        0)
    assert "MISMATCH" in capsys.readouterr().out


def test_static_engine_refuses_trace_and_metrics():
    for flag in ("--trace-out", "--metrics-jsonl"):
        with pytest.raises(SystemExit) as ei:
            serve.parse_args(["--engine", "static", flag, "x.json"])
        assert ei.value.code == 2
