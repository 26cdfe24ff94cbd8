"""Serving launcher (port of ``repro/launch/serve.py``): the continuous,
disaggregated and static engines.

Continuous batching under Poisson arrivals over a paged KV pool whose full
pages freeze to 16-value codebooks (``--kv-quant kmeans_ls@16``, the exact
k-means DP, or ``iter_l1@16``, batched FISTA under a per-row lambda
bisection, both solved on the device; or any other count method, such as
``dp@16``, frozen page by page on the host as the reference does), with
chunked prefill, optionally from PTQ'd weights, for the decoder-only
attention archs the port has (qwen3_0_6b, glm4_9b, yi_34b, gemma2_27b and
the MoE granite_moe_3b_a800m):

    python -m repro_torch.launch.serve --engine continuous \\
        --kv-quant kmeans_ls@16 --quantize kmeans_ls@16 --prefill-chunk 64

``--engine disagg`` serves the same trace through disaggregated workers:
``--prefill-workers N`` prefill workers, each with a pool of its own,
hand every finished prompt's pages to one of ``--decode-workers M``
decode workers through a global router (``--staging-depth D`` caps the
prefills in flight past its queue), as fp rows (``--migrate fp``) or as
packed codes + codebooks solved on the prefill worker's pool behind the
prefill (``--migrate frozen``, which needs a ``--kv-quant`` with a device
solver: kmeans_ls, kmeans or iter_l1):

    python -m repro_torch.launch.serve --engine disagg --prefill-workers 1 \\
        --decode-workers 2 --migrate frozen --kv-quant kmeans_ls@16 \\
        --quantize kmeans_ls@16

The summary adds the handoffs, pages and MB that crossed, for each worker.

Overload, on the continuous and disagg engines: ``--preempt`` evicts the
least recently served best_effort sequence when a latency request is
blocked on slots or pages, ``--offload-pages`` demotes a victim's pages to
host memory (frozen pages as their codes + codebooks) and restores them
exactly (without it, or when moving the pages back costs more than
re-prefilling an fp greedy run, the victim is recomputed), and
``--admission slo`` sheds best_effort arrivals while the windowed
inter-token p99 exceeds ``--itl-slo`` seconds and defers them while the
pool is nearly full. ``--priority`` sets every request's tier, or
``--best-effort-frac F`` marks a seed-derived fraction best_effort. The
summary adds admission outcomes by reason and the preemption, offload and
restore counters.
``--prefill-chunk`` and ``--prefix-cache`` serve the colocated pool only,
as in the reference.

Observability, on the continuous and disagg engines: ``--trace-out PATH``
writes a Chrome trace-event JSON of the run (load it at
https://ui.perfetto.dev or ``chrome://tracing``): one track per component
(the router's admit/defer/reject, the prefill workers' dispatch/harvest,
each decode step's dispatch/sync/commit, page transfers with their bytes,
the page-freeze lifecycle queued -> dispatched -> installed | dropped |
rolled_back | offloaded and the page offload -> restored as async spans,
speculative propose/verify/accept/rollback, the cache and roofline
counters), and the run fails unless the trace's counts equal the engine's
counters (it prints "reconciled"). Every span is on the host clock: on the
card it times the enqueue, and the step's ``sync`` span absorbs the device
time queued before it. ``--metrics-jsonl PATH`` writes a strict-JSON
snapshot of the metrics every ``--metrics-interval`` seconds (histogram
percentiles windowed over the interval, the modeled HBM bytes a token and
its time at the H100's 3.35 TB/s) and the final one as Prometheus text at
``PATH.prom``.

``--engine static`` runs the reference's default engine: ``--batch B``
prompts of ``--prompt-len`` tokens prefilled into the model's dense ring
cache, then ``--gen`` greedy decode steps (``launch/static_steps.py``);
``--quantize`` weights are dequantized first, as the reference does. The
port's default engine stays ``continuous``. The static engine also serves
deepseek_v2_lite_16b (MLA + MoE), whisper_tiny (encoder-decoder; its
encoder input is seeded normal frame embeddings of ``--prompt-len``
frames, as the reference's) and the state-space archs rwkv6_3b (RWKV-6)
and jamba_1_5_large_398b (Mamba + attention + MoE; on the card
``--layers 5``).

Where the reference launcher fails, this one refuses with a SystemExit
that names the reason (``family_refusal``): an MLA or state-space mixer
or an encoder-decoder model on a paged engine, ``--quantize`` with an MoE FFN
on a paged engine (the expert products take dense weights), and
qwen2_vl_72b on any engine (no frontend makes its embeddings).

It runs on the card (``--device cuda``, the default, which fails without
a GPU); ``--device cpu --reduced`` runs the reduced config on the host.
``--temperature`` and ``--top-k`` sample the trace (greedy by default;
each request's seed derives from ``--seed``), and
``--freeze-page-budget`` caps the pages frozen a decode step.
Weights are seeded random (``--arch``'s full width and depth unless
``--reduced``; ``--layers N`` keeps the first N layers, for a config
whose full depth does not fit the card, cutting inside a layer group
where N asks for it).

``--quantize SPEC`` post-training quantizes every projection on the
serving device (embed and lm_head stay dense), one leaf at a time with the
spec's host solver (a count spec like ``kmeans_ls@16`` or a lam spec like
``l1_ls:lam=0.05``), and serves the codes
undequantized through the codebook-dequant kernel; the run fails if any
quantized matmul fell back to a dense weight
(``qmatmul_dequant_fallback != 0``). The replays below serve the same
codes: their f32 copies change only the dense dtype of a quantized leaf.

With ``--kv-quant`` the run replays a deterministic batch through the fp
engine and the quantized one and fails on a logit deviation above the
reference's tolerance: <= 8% of the logit range, and abs <= 2.5 on the
reduced configs it was calibrated on (at full width the logit range is
several times larger, and so is the absolute deviation). With
``--prefill-chunk`` it replays the batch chunked and single-shot through
the gather read path, in f32 on f32 copies of the weights, on an fp pool
and on the ``--kv-quant`` pool, and fails unless their greedy tokens are
equal and their logits agree within ``CHUNKED_REL_TOL`` of the range. The
quantized-vs-fp replay compares logits while the two runs' greedy
contexts agree: once a near-tie flips a token the runs score different
contexts, and their logits say nothing about the quantizer.

``--speculate k`` drafts k tokens a step with ``--draft-config`` (auto:
the target's first half of layers, sharing its embed, norm, head and
codes; self: the target itself; or an arch name with the same vocab) and
verifies them in one (B, k+1) window of the target; greedy only. The run
then replays a batch of page-aligned prompts through the non-speculative
and the speculative engine, both with ``--kv-quant``, in f32, and fails
unless their greedy tokens are identical and their logits agree within
``SPEC_REL_TOL`` of the range. ``--prefix-cache`` shares full prompt pages across sequences
with a common page-aligned prefix (``--shared-prefix-len N`` gives every
prompt of the trace the same first N tokens); the run then replays
requests with a shared prefix on an fp pool, shared against unshared, and
fails unless some prefill spliced shared pages, the greedy tokens are
identical and the logits agree within ``CHUNKED_REL_TOL["fp"]``.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

import numpy as np
import torch

# The chunked replay differs from single-shot prefill only in the row
# counts of its matmuls (summation order). It runs in f32: in bf16 each such
# difference is a bf16 rounding (0.4%), which 28 layers carry to ~2% of the
# logit range, and no bound there tells that noise from a chunking fault.
# On an fp pool f32 summation order moves logits by ~1e-6 of their range.
# On a quantized pool the freeze solver's discrete choices turn those
# differences into code flips: 0.05-0.18% of the range on the H100, with
# 1% between that and the readings of planted faults (PERF.md).
CHUNKED_REL_TOL = {"fp": 1e-4, "quantized": 0.01}
SERVING_ABS_TOL, SERVING_REL_TOL = 2.5, 0.08
# Speculative vs non-speculative, both on the --kv-quant pool, in f32, the
# freeze budget covering the batch, on page-aligned prompts and fewer new
# tokens than a page holds (speculative_replay): every page either freezes
# at its attach in both engines or never fills, so no verify window reads
# a page exact that the one-token engine reads frozen, whatever k and the
# draft's acceptance (where one does, the reduced config reads 1.3-4.1%
# of the range on the CPU). What is left is the lm_head's torch.matmul at
# B*(k+1) rows instead of B. Readings at full width (tools/
# replay_readings.py --speculate, PERF.md; NVIDIA H100 80GB HBM3, 700 W):
# 0.0001% on prompt seeds 0-2 with the auto draft (91.7% accepted) and
# with chip_smoke.untied_draft (0% accepted, 42 rollbacks), tokens
# identical; the kernel's verify window dropping its own key 0.9011%
# with either draft, every token still identical. 0.1% lies between.
SPEC_REL_TOL = 1e-3
# the reference launcher's PTQ skip list (embed and lm_head stay dense),
# with one change: its "mix" (meant for RWKV's token-mix leaves) also
# matches the "mixer" subtree, which left q/k/v/o dense there; "mix(?!er)"
# keeps the attention projections quantized (ROADMAP, section C)
PTQ_SKIP = ("ln", "norm", "router", "A_log", "mix(?!er)", "dt_bias",
            "D_skip", "w0", "embed", "lm_head")


def _make_draft(params, cfg, args):
    """--draft-config -> (draft_params, draft_cfg): "auto" the target's
    first half of layers (shared embed, norm, head and, PTQ'd, codes),
    "self" the target, or an arch's seeded random weights."""
    from repro_torch import models
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.serving import derive_draft

    name = args.draft_config
    if name in (None, "auto"):
        return derive_draft(params, cfg)
    if name == "self":
        return params, cfg
    dcfg = (get_reduced_config if args.reduced else get_config)(name)
    if dcfg.vocab != cfg.vocab:
        raise SystemExit(f"[serve] draft {name} vocab {dcfg.vocab} != "
                         f"target vocab {cfg.vocab}")
    dev = params["embed"].device
    dparams = models.init_params(
        dcfg, torch.Generator(device=dev).manual_seed(7), dev)
    if cfg.param_dtype != dcfg.param_dtype:       # the f32 replays
        dparams, dcfg = f32_copy(dparams, dcfg)
    return dparams, dcfg


def _make_engine(params, cfg, args, *, kv_quant, record_logits=False,
                 freeze_async=True, attn_impl=None, prefill_chunk=-1,
                 freeze_page_budget=None, speculate=None, prefix_cache=False,
                 max_slots=None, draft=None, overload=False, tracer=None,
                 exporter=None):
    """The engine composition ``args`` asks for (``--engine continuous``
    or ``disagg``), so every replay runs the composition served;
    ``speculate`` (default ``--speculate``) drafts with ``draft`` (params,
    cfg), by default built from ``params`` by ``--draft-config``; the
    freeze budget defaults to ``--freeze-page-budget``. ``overload`` turns
    on the overload flags (the served run; the replays probe an
    uncontended pool), as do ``tracer`` and ``exporter``. A disagg engine
    without ``kv_quant`` migrates fp, the only pages that cross without a
    spec; one that records logits (a replay) blocks on each prefill, so
    two replays run the same schedule whatever the card's timing."""
    from repro_torch.serving import ContinuousBatchingEngine, DisaggEngine

    speculate = args.speculate if speculate is None else speculate
    kw = dict(device=args.device, max_slots=max_slots or args.max_slots,
              block_size=args.block_size, max_seq_len=args.max_seq_len,
              kv_quant=kv_quant,
              kv_num_values=None if kv_quant is None else args.kv_num_values,
              attn_impl=attn_impl or args.attn_impl,
              record_logits=record_logits, freeze_async=freeze_async,
              freeze_page_budget=(args.freeze_page_budget
                                  if freeze_page_budget is None
                                  else freeze_page_budget),
              speculate=speculate,
              draft=(draft or _make_draft(params, cfg, args)) if speculate
              else None, tracer=tracer, exporter=exporter)
    if overload:
        kw.update(offload_pages=args.offload_pages, preempt=args.preempt,
                  admission=args.admission, itl_slo_s=args.itl_slo)
    if args.engine == "disagg":
        return DisaggEngine(params, cfg,
                            prefill_workers=args.prefill_workers,
                            decode_workers=args.decode_workers,
                            migrate=(args.migrate if kv_quant is not None
                                     else "fp"),
                            staging_depth=args.staging_depth,
                            block_prefill=record_logits, **kw)
    return ContinuousBatchingEngine(
        params, cfg, prefix_cache=prefix_cache,
        prefill_chunk=(args.prefill_chunk if prefill_chunk == -1
                       else prefill_chunk), **kw)


def f32_copy(params, cfg):
    """f32 copies of the weights and the config computing in f32. A
    QuantizedTensor leaf keeps its codes and codebook (``.float()``
    changes only its dense dtype): the replay serves the same model."""
    def up(t):
        if isinstance(t, dict):
            return {k: up(v) for k, v in t.items()}
        if isinstance(t, list):
            return [up(v) for v in t]
        return t.float()
    return up(params), dataclasses.replace(cfg, param_dtype="float32",
                                           compute_dtype="float32")


def _replay_prompts(cfg, args, prompt_len=None) -> list[list[int]]:
    rng = np.random.default_rng(args.seed)
    return [rng.integers(0, cfg.vocab, prompt_len or args.prompt_len)
            .tolist() for _ in range(min(3, args.max_slots))]


def compare_replays(a, b, outs_a, outs_b) -> dict:
    """Logit deviation of two engines' recorded request logits over the
    steps where their greedy contexts agree (every step up to and
    including the first token that differs), plus token agreement."""
    dmax = scale = dsum = 0.0
    count = agree = total = 0
    for i in sorted(outs_a):
        ta, tb = outs_a[i], outs_b[i]
        n = 0
        while n < min(len(ta), len(tb)) and ta[n] == tb[n]:
            n += 1
        steps = min(n + 1, len(ta), len(tb))
        la, lb = a.request_logits[i][:steps], b.request_logits[i][:steps]
        d = np.abs(la - lb)
        dmax = max(dmax, float(d.max()))
        dsum += float(d.sum())
        count += d.size
        scale = max(scale, float(np.abs(la).max()))
        agree += sum(int(x == y) for x, y in zip(ta, tb))
        total += len(ta)
    return {"dmax": dmax, "dmean": dsum / max(count, 1), "scale": scale,
            "rel": dmax / max(scale, 1e-9), "agree": agree, "total": total}


def serving_replay(params, cfg, args) -> dict:
    """Replay a deterministic batch through the fp engine vs the quantized
    engine as configured (the same composition as the served one):
    ``compare_replays``'s deviation plus the quantized engine's spec,
    freeze installs and host page solves (summed over decode workers)."""
    prompts = _replay_prompts(cfg, args)
    outs, engines = [], []
    for kv in (None, args.kv_quant):
        eng = _make_engine(params, cfg, args, kv_quant=kv,
                           record_logits=True, speculate=0,
                           freeze_async=False)  # deterministic install step
        outs.append(eng.generate(prompts, max_new_tokens=args.gen))
        engines.append(eng)
    r = compare_replays(engines[0], engines[1], *outs)
    r["spec"] = engines[1].kv_spec
    r["installs"] = engines[1].counters["freeze_installs"]
    r["host_page_solves"] = engines[1].counters["host_page_solves"]
    return r


def _verify_serving(params, cfg, args) -> bool:
    """Report the logit deviation quantized KV pages introduce
    (``serving_replay``) against the reference's tolerance."""
    r = serving_replay(params, cfg, args)
    # the absolute bound is the reference's calibration for reduced
    # configs; the relative one holds at every width
    abs_tol = SERVING_ABS_TOL if args.reduced else math.inf
    ok = r["dmax"] <= abs_tol and r["rel"] <= SERVING_REL_TOL
    print(f"[serve] serving check ({r['spec']}): "
          f"max|dlogit|={r['dmax']:.3f} mean={r['dmean']:.4f} "
          f"rel={r['rel']:.3%} (tolerance: abs<={abs_tol}, "
          f"rel<={SERVING_REL_TOL:.0%}, over agreeing contexts) "
          f"greedy-token agreement {r['agree']}/{r['total']}, "
          f"{r['installs']} freeze installs, {r['host_page_solves']} host "
          f"page solves -> {'OK' if ok else 'EXCEEDED'}")
    return ok


def chunked_replay(params, cfg, args, kv_quant) -> dict:
    """Replay a deterministic batch chunked (--prefill-chunk) vs
    single-shot through the gather read path, in f32: the chunk sequence
    walks the same pages in the same order as one whole-prompt call.

    The freeze budget covers every page of the batch, so each sequence's
    prompt pages freeze right before its first decode step in both runs.
    With a smaller budget the single-shot run, which attaches all prompts
    in one iteration, defers some of them by a step or two while the
    chunked run (one attach at a time) does not, and the runs would read
    different values: a freeze-timing difference, not a chunking one.

    Returns ``compare_replays``'s deviation plus whether the greedy tokens
    are equal and the chunked run's chunk count."""
    params, cfg = f32_copy(params, cfg)
    prompts = _replay_prompts(cfg, args)
    budget = _replay_budget(args, len(prompts))
    outs, engines = [], []
    for chunk in (None, args.prefill_chunk):
        eng = _make_engine(params, cfg, args, kv_quant=kv_quant,
                           record_logits=True, freeze_async=False,
                           attn_impl="gather", prefill_chunk=chunk,
                           freeze_page_budget=budget, speculate=0)
        outs.append(eng.generate(prompts, max_new_tokens=args.gen))
        engines.append(eng)
    single, chunked = engines
    r = compare_replays(single, chunked, *outs)
    r["tokens_equal"] = outs[0] == outs[1]
    r["chunks"] = chunked.prefill.counters["prefill_chunks"]
    return r


def _verify_chunked(params, cfg, args) -> bool:
    """On an fp pool, and on the --kv-quant pool if there is one, the
    chunked replay must give the single-shot run's greedy tokens and its
    logits within CHUNKED_REL_TOL of their range."""
    ok = True
    for kv in dict.fromkeys((None, args.kv_quant)):
        r = chunked_replay(params, cfg, args, kv)
        tol = CHUNKED_REL_TOL["quantized" if kv else "fp"]
        good = r["tokens_equal"] and r["rel"] <= tol
        print(f"[serve] chunked-prefill check (chunk={args.prefill_chunk}, "
              f"kv={kv or 'fp'}, gather replay in f32): {r['chunks']} "
              f"chunks, greedy tokens "
              f"{'equal' if r['tokens_equal'] else 'DIFFER'} "
              f"({r['agree']}/{r['total']} agree), "
              f"max|dlogit|={r['dmax']:.4g} rel={r['rel']:.3g} (tolerance "
              f"rel<={tol:g}) -> {'OK' if good else 'MISMATCH'}")
        ok = ok and good
    return ok


def _replay_budget(args, n_prompts: int) -> int:
    """A freeze budget covering every page of a replay batch: each
    prompt's pages freeze at its attach, whatever else the step does."""
    return n_prompts * -(-(args.prompt_len + args.gen + args.speculate)
                         // args.block_size)


def speculative_replay(params, cfg, args, draft_fn=None) -> dict:
    """Replay a deterministic batch through the non-speculative engine and
    the speculative one (``--speculate``; the draft ``draft_fn(params,
    cfg)`` of the f32 copies, by default ``--draft-config``'s), both on
    the ``--kv-quant`` pool with synchronous freezing, in f32 on f32
    copies of the weights.

    The prompts are ``--prompt-len`` rounded down to whole pages and each
    generates fewer tokens than a page holds, with a freeze budget
    covering the batch: both engines freeze every prompt page at its
    attach and no page fills during decode. So every query of both reads
    the same pages in the same state, whatever the windows' alignment
    and the draft's acceptance (a page filling inside a verify window
    would serve its exact rows to the window's later queries, where the
    one-token engine reads it frozen: a freeze-timing difference, not a
    speculative one).

    Returns ``compare_replays``'s deviation, whether the greedy tokens are
    equal, and the speculative run's acceptance, rollbacks and
    tokens/step."""
    params, cfg = f32_copy(params, cfg)
    bs = args.block_size
    prompts = _replay_prompts(cfg, args, max(args.prompt_len // bs, 1) * bs)
    gen = min(args.gen, bs - 1)
    draft = (draft_fn or (lambda p, c: _make_draft(p, c, args)))(params, cfg)
    outs, engines = [], []
    for k in (0, args.speculate):
        eng = _make_engine(params, cfg, args, kv_quant=args.kv_quant,
                           record_logits=True, freeze_async=False,
                           speculate=k, draft=draft,
                           freeze_page_budget=_replay_budget(args,
                                                             len(prompts)))
        outs.append(eng.generate(prompts, max_new_tokens=gen))
        engines.append(eng)
    base, spec = engines
    r = compare_replays(base, spec, *outs)
    r["tokens_equal"] = outs[0] == outs[1]
    s = spec.metrics.summary()
    r.update(acceptance=s.get("spec_acceptance_rate", 0.0),
             proposed=s.get("spec_proposed", 0),
             rollbacks=s.get("spec_rollbacks", 0),
             tokens_per_step=((s.get("gen_tokens", 0) - s.get("completed", 0))
                              / max(spec.counters["seq_decode_steps"], 1)))
    return r


def _verify_speculative(params, cfg, args) -> bool:
    """Greedy token identity of the speculative engine with the
    non-speculative one (the reference's bar) and logits within
    SPEC_REL_TOL of the range."""
    r = speculative_replay(params, cfg, args)
    ok = r["tokens_equal"] and r["rel"] <= SPEC_REL_TOL
    print(f"[serve] speculative check (speculate={args.speculate}, "
          f"draft={args.draft_config}, kv={args.kv_quant or 'fp'}, f32): "
          f"greedy tokens {'identical' if r['tokens_equal'] else 'DIFFER'} "
          f"({r['agree']}/{r['total']}), max|dlogit|={r['dmax']:.4g} "
          f"rel={r['rel']:.3g} (tolerance rel<={SPEC_REL_TOL:g}); "
          f"acceptance "
          f"{r['acceptance']:.1%} over {r['proposed']} drafts, "
          f"{r['rollbacks']} rollbacks, tokens/step "
          f"{r['tokens_per_step']:.2f} -> {'OK' if ok else 'MISMATCH'}")
    return ok


def disagg_replay(params, cfg, args) -> dict:
    """Replay a deterministic batch through the colocated engine and the
    disaggregated one (``--prefill-workers``/``--decode-workers``, fp
    migration) on an fp pool, whole-prompt prefills and synchronous
    freezing, in f32 on f32 copies of the weights: the pages cross
    unchanged, so only the decode batches' composition (one attach an
    iteration from a prefill worker, against all at once) can move a
    logit. The prompts are cut to --prompt-len, and 1 and 2 times half a
    page plus one token shorter, so the handoffs carry tail rows as well
    as whole pages. Returns ``compare_replays``'s deviation, whether the
    greedy tokens are equal, the disagg run's handoffs and the prompt
    lengths."""
    params, cfg = f32_copy(params, cfg)
    cut = args.block_size // 2 + 1
    prompts = [p[:max(len(p) - i * cut, 1)]
               for i, p in enumerate(_replay_prompts(cfg, args))]
    outs, engines = [], []
    for engine in ("continuous", "disagg"):
        a = argparse.Namespace(**{**vars(args), "engine": engine})
        eng = _make_engine(params, cfg, a, kv_quant=None, record_logits=True,
                           freeze_async=False, prefill_chunk=None,
                           speculate=0)
        outs.append(eng.generate(prompts, max_new_tokens=args.gen))
        engines.append(eng)
    r = compare_replays(engines[0], engines[1], *outs)
    r["tokens_equal"] = outs[0] == outs[1]
    r["handoffs"] = engines[1].counters["migrated_seqs"]
    r["prompt_lens"] = [len(p) for p in prompts]
    return r


def _prefix_requests(cfg, args) -> list:
    """Three requests whose prompts share their first tokens (the trace's
    --shared-prefix-len, else every full page but the last). In two
    slots the first two start together (their chunked prefills overlap,
    so neither can share the other's pages); the second generates least,
    so the third is admitted while the first, published, is still live."""
    from repro_torch.serving import Request

    bs, P = args.block_size, args.prompt_len
    shared = args.shared_prefix_len or max(P - 1, 0) // bs * bs
    rng = np.random.default_rng(args.seed)
    common = tuple(int(x) for x in rng.integers(0, cfg.vocab, shared))
    gens = (args.gen, max(args.gen // 4, 1), max(args.gen // 2, 1))
    return [Request(id=i, prompt=common + tuple(
                int(x) for x in rng.integers(0, cfg.vocab, P - shared)),
                    max_new_tokens=g) for i, g in enumerate(gens)]


def prefix_replay(params, cfg, args) -> dict:
    """Requests sharing a prompt prefix (``_prefix_requests``) through an
    fp-pool engine without and with the prefix cache (two slots, so the
    third request is admitted while a sharer is live), in f32, read path
    and chunking as ``args`` asks: ``compare_replays``'s deviation,
    whether the greedy tokens are equal, the shared run's prefix counters
    and whether both pools drained."""
    params, cfg = f32_copy(params, cfg)
    reqs = _prefix_requests(cfg, args)
    engines = []
    for pc in (False, True):
        eng = _make_engine(params, cfg, args, kv_quant=None,
                           record_logits=True, freeze_async=False,
                           speculate=0, prefix_cache=pc, max_slots=2)
        eng.run(list(reqs))
        engines.append(eng)
    base, shared = engines
    r = compare_replays(base, shared, base.outputs, shared.outputs)
    r["tokens_equal"] = base.outputs == shared.outputs
    r.update({k: shared.counters[k] for k in
              ("prefix_hits", "prefix_shared_pages", "cow_copies")})
    r["drained"] = all(e.worker.alloc.num_free == e.worker.num_blocks - 1
                       for e in engines)
    return r


def _verify_prefix(params, cfg, args) -> bool:
    """Shared vs unshared prompt pages on an fp pool: prefills splice
    shared pages, the greedy tokens are identical and the logits agree
    within CHUNKED_REL_TOL["fp"] of the range."""
    r = prefix_replay(params, cfg, args)
    tol = CHUNKED_REL_TOL["fp"]
    ok = (r["prefix_hits"] >= 1 and r["tokens_equal"] and r["drained"]
          and r["rel"] <= tol)
    print(f"[serve] prefix-sharing check (fp pool, f32): "
          f"{r['prefix_hits']} hits, {r['prefix_shared_pages']} pages "
          f"spliced shared, {r['cow_copies']} copy-on-write, greedy tokens "
          f"{'identical' if r['tokens_equal'] else 'DIFFER'} "
          f"({r['agree']}/{r['total']}), max|dlogit|={r['dmax']:.4g} "
          f"rel={r['rel']:.3g} (tolerance rel<={tol:g}), pools "
          f"{'drained' if r['drained'] else 'LEAKED'} "
          f"-> {'OK' if ok else 'MISMATCH'}")
    return ok


def _ptq_spec(args) -> str:
    """--quantize value -> spec string (a bare method name combines with
    --num-values and the weighted objective, as in the reference)."""
    q = args.quantize
    if "@" in q or ":" in q:
        return q
    return f"{q}@{args.num_values}:weighted=true"


def quantize_params(params, args, dev):
    """PTQ every projection on ``dev``; prints the reference's report line
    plus the PTQ time. Returns (qparams, {tensors, compression, time_s})."""
    from repro_torch.quant import compression_ratio, quantize_tree

    spec = _ptq_spec(args)
    t0 = time.perf_counter()
    params, report = quantize_tree(params, spec, skip_patterns=PTQ_SKIP)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    info = {"tensors": len(report), "compression": compression_ratio(report),
            "time_s": time.perf_counter() - t0}
    print(f"[serve] PTQ {spec}: {info['tensors']} tensors, "
          f"{info['compression']:.1f}x, serving undequantized via qmatmul "
          f"({info['time_s']:.1f}s on {dev})")
    return params, info


def family_refusal(cfg, args) -> str | None:
    """Why the launcher refuses to serve ``cfg`` with ``args``, or None.
    Each refusal is a configuration the reference launcher fails on."""
    if cfg.input_kind == "embeds" and cfg.family == "lm":
        return (f"{cfg.name} takes precomputed embeddings and M-RoPE "
                f"positions from a vision frontend that neither package "
                f"has, so no engine can make its inputs (drive it through "
                f"repro_torch.models with embeds)")
    if args.engine == "static":
        return None
    if cfg.family != "lm":
        return (f"{cfg.name} is an encoder-decoder model; the paged engines "
                f"serve decoder-only LMs (use --engine static)")
    mixers = sorted({sp.mixer for sp in cfg.layer_specs()} - {"attn"})
    if mixers:
        return (f"{cfg.name} has {'/'.join(mixers)} layers; the paged "
                f"engines serve attention mixers only (use --engine "
                f"static)")
    if args.quantize and any(sp.ffn == "moe" for sp in cfg.layer_specs()):
        return (f"--quantize on a paged engine serves weights as codes, and "
                f"{cfg.name}'s MoE expert products take dense weights only "
                f"(use --engine static, which dequantizes)")
    return None


def load_config(args):
    """``--arch``'s config (reduced, depth-cut by ``--layers``), its full
    depth, and a SystemExit when ``family_refusal`` refuses it."""
    from repro_torch.configs import get_config, get_reduced_config

    cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    reason = family_refusal(cfg, args)
    if reason:
        raise SystemExit(f"[serve] refused: {reason}")
    full = cfg.n_layers
    if args.layers:
        cfg = cut_depth(cfg, args.layers)
    return cfg, full


def full_context_layers(cfg) -> int:
    """Layers whose attention reads the paged pool through the kernel (a
    local-window layer reads by gather, as in the reference)."""
    return sum(1 for spec in cfg.layer_specs() if spec.window is None)


def cut_depth(cfg, n_layers: int):
    """``cfg`` with its first ``n_layers`` layers. A whole number of groups
    after the head layers keeps the pattern; a cut inside a group (jamba's
    8-layer group at ``--layers 5``) makes those layers head layers with
    no group after them."""
    if not 0 < n_layers <= cfg.n_layers:
        raise ValueError(f"--layers {n_layers}: want 1..{cfg.n_layers}")
    rest = n_layers - len(cfg.head_layers)
    if rest >= 0 and rest % len(cfg.group) == 0:
        return dataclasses.replace(cfg, n_layers=n_layers).validate()
    return dataclasses.replace(
        cfg, n_layers=n_layers,
        head_layers=tuple(cfg.layer_specs()[:n_layers])).validate()


def cut_params(params, n_layers: int):
    """The first ``n_layers`` layers of ``params`` (the rest shared)."""
    return {**params, "layers": params["layers"][:n_layers]}


def _trace_reconcile(tracer, s, speculate: int) -> bool:
    """Hold the trace's event counts to the engine's counters: decode
    steps, freeze flushes, prefill chunks, page-freeze spans opened and
    ended, speculative accepts and rollbacks, page-offload spans (each
    ended "restored", as many as pages offloaded and restored), preempt
    and restore instants, and prefix matches. A trace is trusted only if
    its counts are the counters. Prints the reading; True if they agree."""
    from repro_torch.obs import count_events

    ev = tracer.events
    n_step = count_events(ev, name="decode_step", ph="X")
    n_flush = count_events(ev, name="flush", ph="X")
    nb = count_events(ev, name="page_freeze", ph="b")
    ne = count_events(ev, name="page_freeze", ph="e")
    states: dict = {}
    for e in ev:
        if e.get("ph") == "e" and e.get("name") == "page_freeze":
            st = e.get("args", {}).get("state", "?")
            states[st] = states.get(st, 0) + 1
    n_pc = count_events(ev, name="prefill_chunk", ph="X")
    ok = (n_step == s.get("decode_steps", 0)
          and n_flush == s.get("freeze_dispatches", 0) and nb == ne
          and n_pc == s.get("prefill_chunks", 0))
    if speculate:
        n_acc = count_events(ev, name="accept", ph="i")
        n_rb = count_events(ev, name="rollback", ph="i")
        ok = ok and (n_acc == s.get("spec_steps", 0)
                     and n_rb == s.get("spec_rollbacks", 0))
    ob = count_events(ev, name="page_offload", ph="b")
    oe = count_events(ev, name="page_offload", ph="e")
    o_restored = sum(1 for e in ev if e.get("name") == "page_offload"
                     and e.get("ph") == "e"
                     and e.get("args", {}).get("state") == "restored")
    ok = ok and (ob == oe == o_restored == s.get("offloaded_pages", 0)
                 == s.get("restored_pages", 0))
    ok = ok and (count_events(ev, name="preempt", ph="i")
                 == s.get("preemptions", 0))
    ok = ok and (count_events(ev, name="restore", ph="i")
                 == s.get("restored_seqs", 0))
    # every counted prefix hit has one prefix_match span (a prefill's
    # splice or a restore's), and no span lacks its hit
    n_pm = count_events(ev, name="prefix_match", ph="X")
    ok = ok and n_pm == s.get("prefix_hits", 0)
    state_txt = (", ".join(f"{k}={v}" for k, v in sorted(states.items()))
                 or "none")
    more = f", page-offload spans {ob} -> {oe} restored" if ob else ""
    if n_pm or s.get("prefix_hits"):
        more += (f", prefix_match spans {n_pm} "
                 f"(counter {s.get('prefix_hits', 0)})")
    if n_pc or s.get("prefill_chunks"):
        more += (f", prefill_chunk spans {n_pc} "
                 f"(counter {s.get('prefill_chunks', 0)})")
    if speculate:
        more += (f", accept {n_acc} (counter {s.get('spec_steps', 0)}), "
                 f"rollback {n_rb} (counter {s.get('spec_rollbacks', 0)})")
    print(f"[serve] trace: {len(ev)} events | decode_step spans {n_step} "
          f"(counter {s.get('decode_steps', 0)}), freeze flushes {n_flush} "
          f"(counter {s.get('freeze_dispatches', 0)}), page-freeze spans "
          f"{nb} opened -> {ne} terminal ({state_txt}){more} "
          f"-> {'reconciled' if ok else 'MISMATCH'}")
    return ok


def serve(args, params=None):
    """Serve a Poisson trace and print the summary. Returns (summary,
    params, cfg). The weights are ``params`` if given (for ``--arch``'s
    config: already PTQ'd weights are served as they are), else seeded
    random ones, PTQ'd with --quantize."""
    from repro_torch import models
    from repro_torch.device import resolve_device
    from repro_torch.serving import poisson_trace

    cfg, full = load_config(args)
    dev = resolve_device(args.device)
    ptq = None
    if params is None:
        params = models.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        if args.quantize:
            params, ptq = quantize_params(params, args, dev)
    tracer = exporter = None
    if args.trace_out or args.metrics_jsonl:
        from repro_torch.obs import MetricsExporter, Tracer

        if args.trace_out:
            tracer = Tracer()
        if args.metrics_jsonl:
            exporter = MetricsExporter(args.metrics_jsonl,
                                       interval_s=args.metrics_interval)
    eng = _make_engine(params, cfg, args, kv_quant=args.kv_quant,
                       prefix_cache=args.prefix_cache, overload=True,
                       tracer=tracer, exporter=exporter)
    trace = poisson_trace(args.num_requests, args.request_rate,
                          vocab=cfg.vocab, prompt_len=args.prompt_len,
                          max_new_tokens=args.gen, seed=args.seed,
                          temperature=args.temperature, top_k=args.top_k,
                          best_effort_frac=(1.0 if args.priority
                                            == "best_effort"
                                            else args.best_effort_frac),
                          shared_prefix_len=args.shared_prefix_len)
    disagg = args.engine == "disagg"
    tag = (f"disagg {args.prefill_workers}P/{args.decode_workers}D "
           f"migrate={eng.migrate}" if disagg else "continuous batching")
    draft = eng.decode[0].draft if disagg else eng.worker.draft
    over = [n for n, on in (("preempt", args.preempt),
                            ("offload-pages", args.offload_pages),
                            (f"admission slo, itl_slo {args.itl_slo}s",
                             args.admission == "slo")) if on]
    n_be = sum(r.priority == "best_effort" for r in trace)
    sampling = ("greedy" if args.temperature <= 0 else
                f"T={args.temperature}, top_k={args.top_k}")
    print(f"[serve] {tag} on {dev} ({cfg.name}, "
          f"{cfg.n_layers} layers"
          + (f" of {full}" if cfg.n_layers != full else "")
          + f", {cfg.compute_dtype}): "
          f"{args.num_requests} requests, Poisson rate {args.request_rate}/s, "
          f"prompt {args.prompt_len}, gen {args.gen}, {args.max_slots} slots "
          f"x {args.max_seq_len} tokens, block {args.block_size}, "
          f"kv={eng.kv_spec or 'fp'}, attn_impl={eng.attn_impl}, "
          f"sampling {sampling}, freeze budget {args.freeze_page_budget} "
          f"pages a step"
          + (f", speculate={args.speculate} (draft {draft.cfg.name}, "
             f"{draft.cfg.n_layers} layers)" if args.speculate else "")
          + (f", prefix cache (shared prefix {args.shared_prefix_len} "
             f"tokens)" if args.prefix_cache else "")
          + (f", overload ({', '.join(over)})" if over else "")
          + (f", {n_be} best_effort requests" if n_be else ""))
    try:
        s = eng.run(trace)
    finally:
        if exporter is not None:
            exporter.close(eng.metrics)       # the final snapshot
    if ptq is not None:
        s["ptq"] = ptq
    if exporter is not None:
        from repro_torch.obs import prometheus_text

        prom_path = args.metrics_jsonl + ".prom"
        with open(prom_path, "w") as f:
            f.write(prometheus_text(eng.metrics.snapshot()))
        print(f"[serve] metrics: {len(exporter.lines)} snapshots -> "
              f"{args.metrics_jsonl} (+ {prom_path})")
    if tracer is not None:
        tracer.write(args.trace_out)
        print(f"[serve] trace -> {args.trace_out} (load at "
              f"https://ui.perfetto.dev or chrome://tracing; host-clock "
              f"spans, not a device profile)")
        if not _trace_reconcile(tracer, s, args.speculate):
            raise SystemExit("[serve] trace/counter reconciliation failed")
    if not s["completed"]:
        raise SystemExit(f"[serve] no requests completed ({s['rejected']} "
                         f"rejected: prompt+gen must fit --max-seq-len "
                         f"{args.max_seq_len})")
    print(f"[serve] completed {s['completed']}/{args.num_requests} "
          f"(rejected {s['rejected']}) in {s['makespan_s']:.2f}s: "
          f"{s['throughput_tok_s']:.1f} gen tok/s")
    print(f"[serve] TTFT mean {s['ttft_mean_s']*1e3:.0f}ms "
          f"(= queue wait {s['queue_wait_mean_s']*1e3:.0f}ms + prefill "
          f"compute {s['prefill_compute_mean_s']*1e3:.0f}ms) "
          f"p50 {s['ttft_p50_s']*1e3:.0f}ms p99 {s['ttft_p99_s']*1e3:.0f}ms"
          f" | TPOT p50 {s['tpot_p50_s']*1e3:.1f}ms "
          f"p99 {s['tpot_p99_s']*1e3:.1f}ms")
    print(f"[serve] cache occupancy mean "
          f"{s.get('cache_occupancy_mean', 0.0):.1%} max "
          f"{s.get('cache_occupancy_max', 0.0):.1%}")
    print(f"[serve] attn_impl={s['attn_impl']}: "
          f"{s['paged_attention_launches']} paged-attention kernel launches "
          f"({s['decode_steps']} decode steps + {s['prefill_chunks']} "
          f"prefill chunks, {full_context_layers(cfg)} full-context "
          f"layers"
          + ("; the prefill workers' whole-prompt prefills read by gather"
             if disagg else "") + ") | freeze: "
          f"{s['freeze_dispatches']} dispatches -> {s['freeze_installs']} "
          f"installs, {s['host_page_solves']} host page solves, "
          f"{s['freeze_overlap_steps']} decode steps ran between "
          f"dispatch and install, {s['freeze_deferred_pages']} pages "
          f"deferred by the per-step budget | read window <= "
          f"{s['max_gather_blocks']} blocks")
    if args.prefill_chunk:
        print(f"[serve] chunked prefill: {s['prefill_chunks']} chunks of <= "
              f"{args.prefill_chunk} tokens interleaved with decode steps")
    if args.prefix_cache:
        print(f"[serve] prefix cache: {s['prefix_hits']} hits, "
              f"{s['prefix_shared_pages']} pages spliced shared, "
              f"{s['cow_copies']} copy-on-write tail materializations")
    adm = {k: s[k] for k in ("rejected_queue_full", "rejected_pool_full",
                             "shed_slo", "deferred") if s.get(k)}
    if adm or args.admission == "slo":
        print(f"[serve] admission ({args.admission}"
              + (f", itl_slo={args.itl_slo}s" if args.itl_slo else "")
              + "): " + (", ".join(f"{k}={v}" for k, v in adm.items())
                         or "none"))
    if s.get("preemptions"):
        comp = s.get("offload_compression", 0.0)
        print(f"[serve] overload: {s['preemptions']} preemptions "
              f"({s['preempt_offloads']} offloaded to host, "
              f"{s['preempt_recomputes']} recomputed); "
              f"{s['offloaded_pages']} pages -> host tier at "
              f"{s['offload_bytes'] / 1e6:.3f} MB"
              + (f" ({comp:.2f}x smaller than fp)" if comp else "")
              + f", {s['restored_seqs']} sequences "
              f"({s['restored_pages']} pages) restored")
    if disagg:
        print(f"[serve] migration ({eng.migrate}): {s['prefills_done']} "
              f"prefills -> {s['migrated_seqs']} handoffs, "
              f"{s['migrated_pages']} pages, "
              f"{s['migrate_bytes'] / 1e6:.3f} MB crossed "
              f"({s['migrate_compression']:.2f}x fewer than fp rows at "
              f"{s['migrate_fp_equiv_bytes'] / 1e6:.3f} MB)"
              + (f", {s['migrate_solves']} page solves on the prefill "
                 f"workers" if eng.migrate == "frozen" else ""))
        for i, w in enumerate(s["per_worker"]["prefill"]):
            print(f"[serve]   prefill worker {i}: {w['prefills']} prefills, "
                  f"{w['migrated_pages']} pages, "
                  f"{w['migrate_bytes'] / 1e6:.3f} MB out")
        for i, w in enumerate(s["per_worker"]["decode"]):
            print(f"[serve]   decode worker {i}: {w['migrated_seqs']} "
                  f"handoffs, {w['migrated_pages']} pages, "
                  f"{w['migrate_bytes'] / 1e6:.3f} MB in")
    if args.speculate:
        print(f"[serve] speculative: acceptance "
              f"{s.get('spec_acceptance_rate', 0.0):.1%} "
              f"({s.get('spec_accepted', 0)}/{s.get('spec_proposed', 0)} "
              f"drafts), {s.get('spec_rollbacks', 0)} rollbacks, "
              f"tokens/step {s.get('tokens_per_step', 1.0):.2f}, draft "
              f"{s['draft_prefills']} prefills + {s['draft_steps']} windows")
    if args.quantize:
        fb = s["qmatmul_dequant_fallback"]
        print(f"[serve] quantized weights: {s['quant_matmul_launches']} "
              f"quant_matmul launches, qmatmul_dequant_fallback={fb} "
              f"(every PTQ'd projection must serve from codes)")
        if fb:
            raise SystemExit("[serve] PTQ run took a dense dequant fallback "
                             "in qmatmul")
    if args.kv_quant:
        print(f"[serve] cache bytes: frozen-page compression "
              f"{s['page_compression']:.1f}x per page; measured mean "
              f"{s.get('cache_compression_mean', 1.0):.1f}x, at last "
              f"occupied step {s.get('cache_compression_final', 1.0):.1f}x "
              f"(partial pages stay fp)")
    return s, params, cfg


def static_prompts(cfg, args, dev) -> torch.Tensor:
    """``--batch`` seeded prompts of ``--prompt-len`` tokens on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    return torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                         generator=gen, device=dev)


def static_encoder_input(cfg, args, dev) -> torch.Tensor | None:
    """An encoder-decoder model's encoder input: seeded normal frame
    embeddings (``--batch``, ``--prompt-len``, d_model) f32 on ``dev``
    (the stub frontend's place), or None for an LM."""
    if cfg.family != "encdec":
        return None
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    return torch.randn((args.batch, args.prompt_len, cfg.d_model),
                       generator=gen, dtype=torch.float32, device=dev)


def run_static(args, params=None) -> dict:
    """The static engine: ``--batch`` prompts through one prefill into the
    dense ring cache and ``--gen`` greedy decode steps. The weights are
    ``params`` if given, else seeded random ones, PTQ'd with --quantize;
    quantized leaves are dequantized first, as in the reference. Returns
    {tokens (B, gen), logits (B, gen, V), seconds, params, cfg}."""
    from repro_torch import models
    from repro_torch.device import resolve_device
    from repro_torch.launch.static_steps import static_generate
    from repro_torch.quant import dequantize_tree

    cfg, full = load_config(args)
    dev = resolve_device(args.device)
    if params is None:
        params = models.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        if args.quantize:
            params, _ = quantize_params(params, args, dev)
    if args.quantize:
        print("[serve] static: the PTQ'd weights dequantized to dense, as "
              "the reference's static path serves them")
    params = dequantize_tree(params)
    tokens = static_prompts(cfg, args, dev)
    enc = static_encoder_input(cfg, args, dev)
    t0 = time.perf_counter()
    out, logits = static_generate(params, cfg, tokens, args.gen, enc)
    out = out.cpu()
    dt = time.perf_counter() - t0
    B, G = args.batch, args.gen
    print(f"[serve] static on {dev} ({cfg.name}, {cfg.n_layers} layers"
          + (f" of {full}" if cfg.n_layers != full else "")
          + f", {cfg.compute_dtype}): {B} requests x {args.prompt_len} + "
          f"{G} tokens in {dt:.2f}s ({B * G / dt:.1f} tok/s, first call "
          f"included); sample: {out[0][:10].tolist()}")
    if not bool(torch.isfinite(logits).all()):
        raise SystemExit("[serve] static: non-finite logits")
    return {"tokens": out, "logits": logits, "seconds": dt,
            "params": params, "cfg": cfg}


def verify(params, cfg, args) -> None:
    """The launcher's replay checks; a breach fails the run."""
    if args.kv_quant and not _verify_serving(params, cfg, args):
        raise SystemExit(1)
    if args.prefill_chunk and not _verify_chunked(params, cfg, args):
        raise SystemExit(1)
    if args.speculate and not _verify_speculative(params, cfg, args):
        raise SystemExit(1)
    if args.prefix_cache and not _verify_prefix(params, cfg, args):
        raise SystemExit(1)


def run(args) -> dict:
    """Serve, print the summary, run the replay checks (the static engine:
    generate and print)."""
    if args.engine == "static":
        return run_static(args)
    s, params, cfg = serve(args)
    verify(params, cfg, args)
    return s


def parse_args(argv=None):
    from repro_torch.configs import ARCHS

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3_0_6b", choices=ARCHS,
                    help="the config to serve (seeded random weights at "
                         "its full width and depth unless --reduced)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the first N layers of --arch (a depth cut; "
                         "inside a layer group where N asks for it)")
    ap.add_argument("--engine", choices=("static", "continuous", "disagg"),
                    default="continuous",
                    help="continuous (default here; the reference launcher "
                         "defaults to static), disagg (prefill workers "
                         "hand pages to decode workers) or static (one "
                         "fixed batch on a dense ring cache)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    ap.add_argument("--batch", type=int, default=4,
                    help="static engine: prompts in the fixed batch")
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="default 64 (16 for the static engine)")
    ap.add_argument("--gen", type=int, default=None,
                    help="new tokens a request; default 32 (16 for the "
                         "static engine)")
    ap.add_argument("--request-rate", type=float, default=4.0,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--num-requests", type=int, default=12)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--max-seq-len", type=int, default=256)
    ap.add_argument("--kv-quant", default=None,
                    help="page codebook QuantSpec of a count method: "
                         "kmeans_ls@16, iter_l1@16 and kmeans@16 solve on "
                         "the device; dp, l0, tv_iter, mog and dtc (e.g. "
                         "dp@16) freeze each page on the host")
    ap.add_argument("--kv-num-values", type=int, default=None,
                    help="count budget for a bare --kv-quant method name "
                         "(default 16; conflicts with a spec-form "
                         "--kv-quant)")
    ap.add_argument("--freeze-page-budget", type=int, default=4,
                    help="most KV pages frozen a decode step (a prefill "
                         "burst's remainder is deferred, and counted)")
    ap.add_argument("--quantize", default=None,
                    help="PTQ the projections with this QuantSpec "
                         "(kmeans_ls@16, l1_ls:lam=0.05; a bare method "
                         "name combines with --num-values)")
    ap.add_argument("--num-values", type=int, default=16)
    ap.add_argument("--attn-impl", choices=("auto", "fused", "gather"),
                    default="auto",
                    help="read path: the paged-attention kernel vs dense "
                         "gather (auto: fused on CUDA)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="admit prompts in N-token chunks, one per engine "
                         "iteration, interleaved with decode steps")
    ap.add_argument("--prefill-workers", type=int, default=1,
                    help="disagg: prefill workers, each with a pool of its "
                         "own")
    ap.add_argument("--decode-workers", type=int, default=1,
                    help="disagg: decode workers, each with a pool and a "
                         "freeze stream of its own")
    ap.add_argument("--migrate", choices=("fp", "frozen"), default="fp",
                    help="disagg: how a finished prompt's pages cross to "
                         "the decode worker: fp rows, or (frozen; needs "
                         "--kv-quant) packed codes + codebooks solved on "
                         "the prefill worker")
    ap.add_argument("--staging-depth", type=int, default=None,
                    help="disagg: most prefills in flight past the waiting "
                         "queue; a decode stall backpressures the prefill "
                         "workers (default: unbounded)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature of the trace (0 = greedy, "
                         "the default and the replays' path)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k truncation when sampling (0 = all)")
    ap.add_argument("--speculate", type=int, default=0,
                    help="draft k tokens a step and verify all k+1 "
                         "positions in one batched target pass (0 = off; "
                         "greedy only)")
    ap.add_argument("--draft-config", default="auto",
                    help="draft model for --speculate: 'auto' (the "
                         "target's first half of layers, shared weights), "
                         "'self' (the target), or an arch name with the "
                         "target's vocab")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share full prompt pages across sequences with a "
                         "common page-aligned prefix (refcounted, "
                         "copy-on-write at the prompt's last page)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="the first N prompt tokens of every request in "
                         "the generated trace are the same")
    ap.add_argument("--offload-pages", action="store_true",
                    help="demote preemption victims' pages to a host tier "
                         "(frozen pages as codes + codebooks) and restore "
                         "them exactly")
    ap.add_argument("--preempt", action="store_true",
                    help="evict the least recently served best_effort "
                         "sequence when a latency request is blocked on "
                         "slots or pages (restore or recompute by the cost "
                         "model; preempted work re-admits ahead of FCFS)")
    ap.add_argument("--admission", choices=("fcfs", "slo"), default="fcfs",
                    help="slo: shed or defer best_effort arrivals by the "
                         "windowed inter-token p99 (--itl-slo) and the "
                         "pool occupancy, protecting the latency tier")
    ap.add_argument("--itl-slo", type=float, default=None,
                    help="inter-token p99 target in seconds for "
                         "--admission slo (unset: occupancy only)")
    ap.add_argument("--priority", choices=("latency", "best_effort"),
                    default="latency",
                    help="tier of every request in the generated trace")
    ap.add_argument("--best-effort-frac", type=float, default=0.0,
                    help="mark this seed-derived fraction of the trace "
                         "best_effort: the tier --admission slo sheds and "
                         "--preempt evicts")
    ap.add_argument("--trace-out", default=None,
                    help="write a Perfetto-loadable Chrome trace-event "
                         "JSON of the run (one track per component; host "
                         "clock) and fail unless its span counts equal the "
                         "engine's counters")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="write a JSON metrics snapshot here every "
                         "--metrics-interval seconds (percentiles windowed "
                         "per interval, modeled HBM bytes/token gauges); "
                         "the final Prometheus text lands at PATH + "
                         "'.prom'")
    ap.add_argument("--metrics-interval", type=float, default=1.0,
                    help="seconds between --metrics-jsonl snapshots")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    serving = args.engine != "static"
    if (args.trace_out or args.metrics_jsonl) and not serving:
        ap.error("--trace-out/--metrics-jsonl instrument the continuous "
                 "and disagg engines")

    if args.prompt_len is None:
        args.prompt_len = 64 if serving else 16
    if args.gen is None:
        args.gen = 32 if serving else 16
    if serving and args.request_rate <= 0:
        ap.error("--request-rate must be > 0 (requests per second)")
    if (args.offload_pages or args.preempt or args.admission == "slo") \
            and not serving:
        ap.error("--offload-pages/--preempt/--admission slo serve the "
                 "continuous and disagg engines")
    if args.engine == "disagg" and args.migrate == "frozen" \
            and not args.kv_quant:
        ap.error("--migrate frozen needs --kv-quant (pages cross as "
                 "codes + codebooks)")
    if not 0.0 <= args.best_effort_frac <= 1.0:
        ap.error("--best-effort-frac must lie in [0, 1]")
    if args.itl_slo is not None and args.itl_slo <= 0:
        ap.error("--itl-slo must be > 0 seconds")
    if args.prefill_chunk is not None:
        if args.engine != "continuous":
            ap.error("--prefill-chunk interleaves the continuous engine's "
                     "decode loop (disagg already overlaps through its "
                     "workers)")
        if args.prefill_chunk < 1:
            ap.error("--prefill-chunk must be >= 1 token")
    if args.prefix_cache and args.engine != "continuous":
        ap.error("--prefix-cache shares pages within one colocated pool "
                 "(the continuous engine); disagg pools migrate pages out")
    if args.speculate < 0:
        ap.error("--speculate must be >= 0")
    if args.speculate and args.temperature > 0:
        ap.error("--speculate serves the greedy path; drop --temperature")
    if args.shared_prefix_len and not serving:
        ap.error("--shared-prefix-len shapes the continuous/disagg trace")
    if not 0 <= args.shared_prefix_len <= args.prompt_len:
        ap.error("--shared-prefix-len must lie in [0, --prompt-len]")
    if args.freeze_page_budget < 1:
        ap.error("--freeze-page-budget must cover >= 1 page")
    if args.prefill_workers < 1 or args.decode_workers < 1:
        ap.error("--prefill-workers and --decode-workers must be >= 1")
    if args.staging_depth is not None and args.staging_depth < 1:
        ap.error("--staging-depth must be >= 1")
    if args.batch < 1:
        ap.error("--batch must be >= 1")
    return args


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
