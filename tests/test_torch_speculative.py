"""Speculative decoding in the port (``serving/speculative.py``, the
speculative paths of ``serving/workers.py``, ``models.decode_window``),
held against the JAX package on the reduced qwen3 config (4 layers, f32,
CPU) and against the port's own non-speculative engine.

Tolerances: the verify window against the reference's ``decode_window``
and against the port's own W sequential steps within atol 1e-4 (the
port's LM bar, tests/test_torch_model.py; on the CPU's gather path a
window sums in another order than single steps, ~1e-5 here); engines on
greedy token identity (the reference's acceptance bar) with request logits
within atol 1e-3 (the reference's engine bar, tests/test_speculative.py).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_reduced_config as jax_reduced_config
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro.serving import derive_draft as jax_derive_draft
from repro.serving.kv_cache import init_paged_cache as jax_init_paged_cache
from repro.serving.kv_cache import merge_pools as jax_merge_pools
from repro.serving.kv_cache import with_tables as jax_with_tables
from repro_torch import models
from repro_torch.configs import get_reduced_config
from repro_torch.models.cache import supports_fused_decode
from repro_torch.serving import (ContinuousBatchingEngine, DecodeWorker,
                                 PagedKVCache, Request, derive_draft,
                                 init_paged_cache, init_paged_layer,
                                 resolve_kv_spec, with_tables)
from repro_torch.serving.kv_cache import PendingFreeze

# tiny tensors: one intra-op thread (more make these shapes far slower)
torch.set_num_threads(1)

pytestmark = pytest.mark.serving

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def reduced():
    jcfg = jax_reduced_config("qwen3_0_6b")
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_reduced_config("qwen3_0_6b")
    params = models.params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def draft(reduced):
    _, _, cfg, params = reduced
    return derive_draft(params, cfg)


def _prompts(cfg, n, plen, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, plen).tolist() for _ in range(n)]


def _random_draft(cfg, seed):
    """A draft with its own random weights and an untied random head:
    near-zero agreement. (With tied embeddings a random model's greedy
    token is mostly its input token, so two such models agree often.)"""
    dcfg = dataclasses.replace(cfg, tie_embeddings=False)
    return models.init_params(dcfg, torch.Generator().manual_seed(seed),
                              "cpu"), dcfg


# ------------------------------------------------------------- the draft


def test_derive_draft_matches_reference_truncation(reduced, draft):
    """The port slices its layer list where the reference slices its
    stacked groups: the same layers, embed, norm and config."""
    jcfg, jparams, cfg, _ = reduced
    jd, jdcfg = jax_derive_draft(jparams, jcfg)
    dparams, dcfg = draft
    for f in ("name", "n_layers", "vocab", "d_model", "head_dim"):
        assert getattr(dcfg, f) == getattr(jdcfg, f), f
    assert dcfg.n_layers == cfg.n_layers // 2
    ref = models.params_from_reference(jax.tree.map(np.asarray, jd), dcfg,
                                       "cpu")
    flat = lambda t: jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda x: x.numpy(), t))[0]
    ours, theirs = flat(dparams), flat(ref)
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(ours, theirs):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # the draft shares the target's tensors (the codes too, when PTQ'd)
    assert dparams["embed"] is reduced[3]["embed"]
    assert dparams["layers"][0] is reduced[3]["layers"][0]


# ---------------------------------------------------- the verify window


BS, P, W = 8, 11, 3


def _window_tokens(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab, (1, P + W))


def _port_prefilled(params, cfg, toks, table):
    pool = init_paged_cache(cfg, num_blocks=6, block_size=BS, device="cpu")
    pad = -(-P // BS) * BS
    tp = np.zeros((1, pad), np.int32)
    tp[0, :P] = toks[0, :P]
    views = with_tables(pool, table[:, :pad // BS], np.zeros((1,), np.int32))
    models.prefill(params, cfg, {"tokens": torch.as_tensor(tp)}, views)
    return pool


def test_decode_window_matches_reference_and_sequential_steps(reduced):
    """One (1, W) window after an 11-token prompt on a paged gather
    cache: against the reference's ``decode_window`` on the same weights,
    and against W sequential port decode steps (atol 1e-4 both)."""
    jcfg, jparams, cfg, params = reduced
    toks = _window_tokens(cfg)
    table = np.asarray([[1, 2, 3, 4]], np.int32)
    lens = np.asarray([P], np.int32)

    pool = _port_prefilled(params, cfg, toks, table)
    views = with_tables(pool, table, lens)
    win, _ = models.decode_window(params, cfg,
                                  torch.as_tensor(toks[:, P:P + W]), views,
                                  views[0].seq_lens)
    pool = _port_prefilled(params, cfg, toks, table)
    seq = []
    for w in range(W):
        views = with_tables(pool, table, lens + w)
        lg, _ = models.decode_step(
            params, cfg, torch.as_tensor(toks[:, P + w:P + w + 1]), views,
            views[0].seq_lens)
        seq.append(lg[0, 0])
    # the CPU's gather path sums in another order for a multi-row query
    # (K/V repeated over the GQA group) and in matmuls of other row
    # counts: ~1e-5 on logits of ~15 (bitwise on the card's kernel,
    # tests/test_torch_cuda.py)
    torch.testing.assert_close(win[0], torch.stack(seq), atol=1e-4,
                               rtol=0)

    kw = dict(num_blocks=6, block_size=BS, batch=1, max_blocks=4)
    tree = jax_init_paged_cache(jcfg, **kw)
    pad = -(-P // BS) * BS
    tp = np.zeros((1, pad), np.int32)
    tp[0, :P] = toks[0, :P]
    _, new = jmodels.prefill(jparams, jcfg, {"tokens": jnp.asarray(tp)},
                             jax_with_tables(tree, table, np.zeros((1,),
                                                                   np.int32)))
    tree = jax_merge_pools(tree, new)
    jwin, _ = jmodels.decode_window(jparams, jcfg,
                                    jnp.asarray(toks[:, P:P + W]),
                                    jax_with_tables(tree, table, lens),
                                    jnp.asarray(lens))
    np.testing.assert_allclose(win.numpy(), np.asarray(jwin), atol=1e-4,
                               rtol=1e-4)
    # W = 1 is exactly decode_step
    pool = _port_prefilled(params, cfg, toks, table)
    views = with_tables(pool, table, lens)
    one, _ = models.decode_window(params, cfg, torch.as_tensor(
        toks[:, P:P + 1]), views, views[0].seq_lens)
    assert torch.equal(one[0, 0], seq[0])


def test_short_prefill_chunk_through_the_fused_decode_gate(reduced,
                                                          monkeypatch):
    """With a verify window of 4 the fused-decode gate also takes prefill
    chunks of <= 4 tokens; that route computes what the fused-prefill
    route computes (valid = offset + C): bitwise, on the layer and as the
    first-token logits of a chunked prefill in an engine."""
    _, _, cfg, params = reduced
    rng = np.random.default_rng(3)
    mk = lambda fw: init_paged_layer(
        cfg, num_blocks=6, block_size=BS, batch=1, max_blocks=3,
        quantized=False, num_values=16, dtype=torch.float32, device="cpu",
        fused=True, fused_window=fw)
    a, b = mk(4), mk(1)
    for c in (a, b):
        torch.manual_seed(0)
        c.k_fp.normal_()
        c.v_fp.normal_()
        c.block_table[:] = torch.tensor([[2, 4, 5]], dtype=torch.int32)
        c.seq_lens[:] = 9
    b.prefill_fused = True
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 3, h, Dh)).astype(
        np.float32)) for h in (H, Hkv, Hkv))
    assert supports_fused_decode(a, 3, None)
    assert not supports_fused_decode(b, 3, None)
    _, out_a = a.fused_decode(q, k, v)
    _, out_b = b.fused_prefill(q, k, v)
    assert torch.equal(out_a, out_b)
    assert torch.equal(a.k_fp, b.k_fp)

    calls = {"decode": 0, "prefill": 0}

    def count(name, fn):
        def wrapped(self, *a, **kw):
            calls[name] += 1
            return fn(self, *a, **kw)
        return wrapped
    monkeypatch.setattr(PagedKVCache, "fused_decode",
                        count("decode", PagedKVCache.fused_decode))
    monkeypatch.setattr(PagedKVCache, "fused_prefill",
                        count("prefill", PagedKVCache.fused_prefill))
    # 20-token prompts pad to 24: eight chunks of 3 tokens each
    prompts = _prompts(cfg, 2, 20, seed=6)
    first = []
    for k_spec in (3, 0):
        eng = ContinuousBatchingEngine(
            params, cfg, device="cpu", max_slots=2, block_size=8,
            max_seq_len=48, attn_impl="fused", record_logits=True,
            prefill_chunk=3, speculate=k_spec,
            draft=derive_draft(params, cfg) if k_spec else None)
        calls.update(decode=0, prefill=0)
        eng.generate(prompts, max_new_tokens=1)
        n = cfg.n_layers * eng.prefill.counters["prefill_chunks"]
        assert n == cfg.n_layers * 16
        # through the decode gate at W = 4, through fused_prefill at W = 1
        assert calls == ({"decode": n, "prefill": 0} if k_spec
                         else {"decode": 0, "prefill": n})
        first.append([eng.request_logits[i][0] for i in range(2)])
    for x, y in zip(*first):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------- engines


def _engine(params, cfg, **kw):
    base = dict(device="cpu", max_slots=2, block_size=8, max_seq_len=48,
                record_logits=True)
    base.update(kw)
    return ContinuousBatchingEngine(params, cfg, **base)


@pytest.mark.parametrize("attn_impl,kv_quant", [("gather", None),
                                                ("fused", "kmeans_ls@16")])
def test_spec_token_identical_and_accepts(reduced, draft, attn_impl,
                                          kv_quant):
    """The half-depth draft reproduces the baseline greedy trace (tokens,
    and logits within 1e-3), accepts drafts, and needs fewer verify steps
    than the baseline decode steps; the fused run's verify windows go
    through the kernel's W = 4 path (on the CPU its plain version)."""
    _, _, cfg, params = reduced
    prompts = _prompts(cfg, 3, 12)
    kw = dict(attn_impl=attn_impl, kv_quant=kv_quant, freeze_async=False)
    base = _engine(params, cfg, **kw)
    out_b = base.generate(prompts, max_new_tokens=8)
    spec = _engine(params, cfg, speculate=3, draft=draft, **kw)
    out_s = spec.generate(prompts, max_new_tokens=8)
    assert out_s == out_b
    for i in range(len(prompts)):
        np.testing.assert_allclose(spec.request_logits[i],
                                   base.request_logits[i], atol=1e-3,
                                   rtol=0)
    s = spec.metrics.summary()
    assert s["spec_acceptance_rate"] > 0
    assert s["spec_proposed"] == 3 * s["spec_steps"]
    assert spec.counters["decode_steps"] < base.counters["decode_steps"]
    tps = (s["gen_tokens"] - s["completed"]) / spec.counters[
        "seq_decode_steps"]
    assert tps > 1.0
    # the draft: one prefill per request, k windows per verify step
    w = spec.worker
    assert w.draft.counters == {"draft_prefills": 3,
                                "draft_steps": 3 * w.counters["decode_steps"]}
    assert w.draft.alloc.num_free == w.draft.num_blocks - 1


def test_spec_identical_under_random_draft_rollbacks(reduced):
    """A random draft (near-zero agreement) still gives the exact
    baseline trace, while rollbacks dominate."""
    _, _, cfg, params = reduced
    prompts = _prompts(cfg, 2, 10, seed=1)
    out_b = _engine(params, cfg).generate(prompts, max_new_tokens=6)
    spec = _engine(params, cfg, speculate=2, draft=_random_draft(cfg, 99))
    assert spec.generate(prompts, max_new_tokens=6) == out_b
    assert spec.metrics.summary()["spec_rollbacks"] > 0


def test_spec_engine_matches_reference_spec_engine(reduced):
    """The port's speculative engine against a live reference
    speculative engine on the same weights and the same draft (kmeans_ls
    @16 pages, chunked prefill, gather reads): same tokens, request
    logits within 1e-3, same acceptance."""
    jcfg, jparams, cfg, params = reduced
    prompts = _prompts(cfg, 3, 12, seed=2)
    kw = dict(max_slots=2, block_size=8, max_seq_len=48,
              kv_quant="kmeans_ls@16", record_logits=True,
              freeze_async=False, attn_impl="gather", prefill_chunk=7,
              speculate=3)
    jeng = JaxEngine(jparams, jcfg, draft=jax_derive_draft(jparams, jcfg),
                     **kw)
    ref = jeng.generate(prompts, max_new_tokens=8)
    eng = ContinuousBatchingEngine(params, cfg, device="cpu",
                                   draft=derive_draft(params, cfg), **kw)
    assert eng.generate(prompts, max_new_tokens=8) == ref
    for i in range(len(prompts)):
        np.testing.assert_allclose(eng.request_logits[i],
                                   jeng.request_logits[i], atol=1e-3,
                                   rtol=0)
    a, b = eng.metrics.summary(), jeng.metrics.summary()
    for key in ("spec_steps", "spec_proposed", "spec_accepted",
                "spec_rollbacks"):
        assert a[key] == b[key], key
    assert eng.counters["freeze_installs"] > 0


# ------------------------------------------------------------- watermark


def test_rollback_never_freezes_past_watermark(reduced):
    """A disagreeing draft forcing rollbacks on a quantized cache with
    async freezing: no frozen, queued or pending page ever lies past the
    accepted seq_lens, checked at every step boundary."""
    _, _, cfg, params = reduced
    eng = ContinuousBatchingEngine(
        params, cfg, device="cpu", max_slots=2, block_size=4,
        max_seq_len=64, kv_quant="kmeans_ls@16", freeze_page_budget=1,
        speculate=3, draft=_random_draft(cfg, 123))
    w = eng.worker
    orig_step = w.step
    violations = []

    def checked_step(now_fn):
        orig_step(now_fn)
        violations.extend(w.frozen_past_watermark())

    w.step = checked_step
    out = eng.generate(_prompts(cfg, 3, 9, seed=4), max_new_tokens=10)
    assert not violations, violations
    assert eng.metrics.summary()["spec_rollbacks"] > 0
    assert all(len(v) == 10 for v in out.values())
    assert w.alloc.num_free == w.num_blocks - 1


def test_rollback_unqueues_freeze_bids(reduced):
    """Optimistic bids for pages past the rolled-back watermark leave the
    queue and in-flight keeps, the frozen watermark shrinks, lens lands on
    the accepted length."""
    _, _, cfg, params = reduced
    w = DecodeWorker(params, cfg, device="cpu", max_slots=1, block_size=4,
                     max_seq_len=32, kv_spec=resolve_kv_spec("kmeans_ls@16"),
                     speculate=2, draft=_random_draft(cfg, 5))
    s = w.slots[0]
    s.blocks = [3, 5, 7]
    w.table[0, :3] = [3, 5, 7]
    # the verify wrote optimistically through 11 rows (3 pages)
    w.lens[0] = 11
    w._queue_freeze(0)
    assert w._freeze_bids == [3, 5] and s.frozen_upto == 2
    # an in-flight solve holding page 5 must drop it too
    pending = PendingFreeze(np.asarray([3, 5], np.int32), None, None)
    w._pending_freezes.append((0, pending))
    # shrinking lens alone leaves page 5 bid past the watermark: the
    # check every step runs (here and in chip_smoke.py) names it
    w.lens[0] = 6
    assert w.frozen_past_watermark() == [(5, 0, 1, 6)]
    w._rollback_slot(0, 6)
    assert w.frozen_past_watermark() == []
    # page 5 (rows 4..7) lies past 6 accepted rows; page 3 stays
    assert w._freeze_bids == [3]
    assert pending.kept_pages() == [3]
    assert s.frozen_upto == 1
    assert int(w.lens[0]) == 6


# ------------------------------------------------------------- guards


def test_spec_engine_guards(reduced, draft):
    """Speculation without a draft, a vocab mismatch, sampled requests and
    a fused verify window wider than a page are named errors; lookahead
    rows count against the sequence budget."""
    _, _, cfg, params = reduced
    with pytest.raises(ValueError, match="draft"):
        ContinuousBatchingEngine(params, cfg, device="cpu", speculate=2)
    bad_cfg = dataclasses.replace(draft[1], vocab=cfg.vocab + 1)
    with pytest.raises(ValueError, match="vocab"):
        ContinuousBatchingEngine(params, cfg, device="cpu", speculate=2,
                                 draft=(draft[0], bad_cfg))
    with pytest.raises(ValueError, match="window"):
        ContinuousBatchingEngine(params, cfg, device="cpu", block_size=4,
                                 speculate=4, attn_impl="fused", draft=draft)
    eng = _engine(params, cfg, speculate=2, draft=draft)
    with pytest.raises(ValueError, match="greedy"):
        eng.submit(Request(id=0, prompt=(1, 2), max_new_tokens=2,
                           temperature=1.0), 0.0)
    assert not eng.submit(Request(id=1, prompt=(1,) * 40,
                                  max_new_tokens=8), 0.0)
    assert eng.worker.sched.rejected == [1]
    # the same request fits without speculation
    assert _engine(params, cfg).submit(
        Request(id=1, prompt=(1,) * 40, max_new_tokens=8), 0.0)


# ------------------------------------------------------------- launcher


def test_launcher_speculative_and_prefix_checks_pass(capsys):
    """The acceptance command on the CPU: PTQ'd weights, kmeans_ls@16
    pages, chunked prefill, --speculate 3 with the auto draft, the prefix
    cache over a trace sharing 32 prompt tokens. It serves and every
    replay check passes: serving, chunked (fp and quantized),
    speculative (identical greedy tokens) and prefix sharing."""
    from repro_torch.launch import serve

    s = serve.main(["--reduced", "--device", "cpu", "--kv-quant",
                    "kmeans_ls@16", "--quantize", "kmeans_ls@16",
                    "--prefill-chunk", "7", "--speculate", "3",
                    "--prefix-cache", "--shared-prefix-len", "32",
                    "--num-requests", "4", "--request-rate", "8",
                    "--gen", "16"])
    out = capsys.readouterr().out
    assert s["completed"] == 4 and s["speculate"] == 3
    assert s["spec_accepted"] > 0 and s["tokens_per_step"] > 1
    assert s["qmatmul_dequant_fallback"] == 0
    assert "speculative check (speculate=3" in out
    assert "greedy tokens identical" in out
    assert "prefix-sharing check" in out
    assert out.count("-> OK") == 5, out


@pytest.mark.parametrize("extra", [
    ["--prompt-len", "61", "--speculate", "3"],
    ["--prompt-len", "64", "--speculate", "2"],
    ["--prompt-len", "40", "--speculate", "4", "--block-size", "8"]])
def test_launcher_speculative_replay_holds_any_window_alignment(reduced,
                                                               extra):
    """The launcher's speculative replay rounds its prompts down to whole
    pages and generates fewer tokens than a page holds, so no page fills
    during decode in either engine: with the auto draft and with a random
    draft that rolls back nearly every window, greedy tokens are
    identical and logits within SPEC_REL_TOL, also where verify windows
    would cross pages (a 61-token prompt; k + 1 not dividing the block),
    which with the full --gen read 1.3-4.1% of the range here."""
    from repro_torch.launch import serve

    _, _, cfg, params = reduced
    args = serve.parse_args(["--reduced", "--device", "cpu", "--kv-quant",
                             "kmeans_ls@16"] + extra)
    for draft_fn in (None, lambda p, c: _random_draft(c, 5)):
        r = serve.speculative_replay(params, cfg, args, draft_fn)
        assert r["tokens_equal"] and r["rel"] <= serve.SPEC_REL_TOL, r
        if draft_fn is not None:
            assert r["rollbacks"] > r["total"] // 2, r


def test_new_modules_import_and_serve_without_jax():
    """The speculative and prefix paths with jax blocked: the port needs
    no JAX for them."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import torch
        import repro_torch.serving.speculative
        import repro_torch.launch.serve
        from repro_torch import models
        from repro_torch.configs import get_reduced_config
        from repro_torch.serving import (ContinuousBatchingEngine,
                                         PrefixIndex, derive_draft)
        assert not any(m == "repro" or m.startswith(("repro.", "jax"))
                       for m in sys.modules if sys.modules[m] is not None)
        cfg = get_reduced_config("qwen3_0_6b")
        params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
        eng = ContinuousBatchingEngine(
            params, cfg, device="cpu", max_slots=1, block_size=8,
            max_seq_len=48, kv_quant="kmeans_ls@16", attn_impl="fused",
            prefill_chunk=5, speculate=2, draft=derive_draft(params, cfg),
            prefix_cache=True)
        p = list(range(1, 20))
        out = eng.generate([p, p], max_new_tokens=3)
        assert [len(v) for v in out.values()] == [3, 3], out
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
