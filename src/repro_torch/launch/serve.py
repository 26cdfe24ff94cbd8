"""Serving launcher (port of ``repro/launch/serve.py``, the continuous
engine).

Continuous batching under Poisson arrivals over a paged KV pool whose full
pages freeze to kmeans_ls codebooks, with chunked prefill, optionally from
PTQ'd weights:

    python -m repro_torch.launch.serve --engine continuous \\
        --kv-quant kmeans_ls@16 --quantize kmeans_ls@16 --prefill-chunk 64

It runs on the card (``--device cuda``, the default, which fails without
a GPU); ``--device cpu --reduced`` runs the reduced config on the host.
Weights are seeded random (``--arch``'s full width and depth unless
``--reduced``).

``--quantize SPEC`` post-training quantizes every projection on the
serving device (embed and lm_head stay dense) and serves the codes
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
# the reference launcher's PTQ skip list (embed and lm_head stay dense),
# with one change: its "mix" (meant for RWKV's token-mix leaves) also
# matches the "mixer" subtree, which left q/k/v/o dense there; "mix(?!er)"
# keeps the attention projections quantized (ROADMAP, section C)
PTQ_SKIP = ("ln", "norm", "router", "A_log", "mix(?!er)", "dt_bias",
            "D_skip", "w0", "embed", "lm_head")


def _make_engine(params, cfg, args, *, kv_quant, record_logits=False,
                 freeze_async=True, attn_impl=None, prefill_chunk=-1,
                 freeze_page_budget=4):
    from repro_torch.serving import ContinuousBatchingEngine

    return ContinuousBatchingEngine(
        params, cfg, device=args.device, max_slots=args.max_slots,
        block_size=args.block_size, max_seq_len=args.max_seq_len,
        kv_quant=kv_quant, attn_impl=attn_impl or args.attn_impl,
        record_logits=record_logits, freeze_async=freeze_async,
        freeze_page_budget=freeze_page_budget,
        prefill_chunk=(args.prefill_chunk if prefill_chunk == -1
                       else prefill_chunk))


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


def _replay_prompts(cfg, args) -> list[list[int]]:
    rng = np.random.default_rng(args.seed)
    return [rng.integers(0, cfg.vocab, args.prompt_len).tolist()
            for _ in range(min(3, args.max_slots))]


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
    return {"dmax": dmax, "dmean": dsum / max(count, 1),
            "rel": dmax / max(scale, 1e-9), "agree": agree, "total": total}


def _verify_serving(params, cfg, args) -> bool:
    """Replay a deterministic batch through the fp engine vs the quantized
    engine as configured and report the logit deviation quantized KV
    pages introduce."""
    prompts = _replay_prompts(cfg, args)
    outs, engines = [], []
    for kv in (None, args.kv_quant):
        eng = _make_engine(params, cfg, args, kv_quant=kv,
                           record_logits=True,
                           freeze_async=False)  # deterministic install step
        outs.append(eng.generate(prompts, max_new_tokens=args.gen))
        engines.append(eng)
    r = compare_replays(engines[0], engines[1], *outs)
    # the absolute bound is the reference's calibration for reduced
    # configs; the relative one holds at every width
    abs_tol = SERVING_ABS_TOL if args.reduced else math.inf
    ok = r["dmax"] <= abs_tol and r["rel"] <= SERVING_REL_TOL
    print(f"[serve] serving check ({engines[1].kv_spec}): "
          f"max|dlogit|={r['dmax']:.3f} mean={r['dmean']:.4f} "
          f"rel={r['rel']:.3%} (tolerance: abs<={abs_tol}, "
          f"rel<={SERVING_REL_TOL:.0%}, over agreeing contexts) "
          f"greedy-token agreement {r['agree']}/{r['total']}, "
          f"{engines[1].counters['freeze_installs']} freeze installs "
          f"-> {'OK' if ok else 'EXCEEDED'}")
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
    budget = len(prompts) * -(-(args.prompt_len + args.gen)
                              // args.block_size)
    outs, engines = [], []
    for chunk in (None, args.prefill_chunk):
        eng = _make_engine(params, cfg, args, kv_quant=kv_quant,
                           record_logits=True, freeze_async=False,
                           attn_impl="gather", prefill_chunk=chunk,
                           freeze_page_budget=budget)
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


def serve(args):
    """Serve a Poisson trace on seeded random weights (PTQ'd with
    --quantize) and print the summary. Returns (summary, params, cfg)."""
    from repro_torch import models
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.device import resolve_device
    from repro_torch.serving import poisson_trace

    dev = resolve_device(args.device)
    cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    params = models.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    ptq = None
    if args.quantize:
        params, ptq = quantize_params(params, args, dev)
    eng = _make_engine(params, cfg, args, kv_quant=args.kv_quant)
    trace = poisson_trace(args.num_requests, args.request_rate,
                          vocab=cfg.vocab, prompt_len=args.prompt_len,
                          max_new_tokens=args.gen, seed=args.seed)
    print(f"[serve] continuous batching on {dev} ({cfg.name}, "
          f"{cfg.n_layers} layers, {cfg.compute_dtype}): "
          f"{args.num_requests} requests, Poisson rate {args.request_rate}/s, "
          f"prompt {args.prompt_len}, gen {args.gen}, {args.max_slots} slots "
          f"x {args.max_seq_len} tokens, block {args.block_size}, "
          f"kv={eng.kv_spec or 'fp'}, attn_impl={eng.attn_impl}")
    s = eng.run(trace)
    if ptq is not None:
        s["ptq"] = ptq
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
          f"prefill chunks, {cfg.n_layers} layers) | freeze: "
          f"{s['freeze_dispatches']} dispatches -> {s['freeze_installs']} "
          f"installs, {s['freeze_overlap_steps']} decode steps ran between "
          f"dispatch and install, {s['freeze_deferred_pages']} pages "
          f"deferred by the per-step budget | read window <= "
          f"{s['max_gather_blocks']} blocks")
    if args.prefill_chunk:
        print(f"[serve] chunked prefill: {s['prefill_chunks']} chunks of <= "
              f"{args.prefill_chunk} tokens interleaved with decode steps")
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


def verify(params, cfg, args) -> None:
    """The launcher's replay checks; a breach fails the run."""
    if args.kv_quant and not _verify_serving(params, cfg, args):
        raise SystemExit(1)
    if args.prefill_chunk and not _verify_chunked(params, cfg, args):
        raise SystemExit(1)


def run(args) -> dict:
    """Serve, print the summary, run the replay checks."""
    s, params, cfg = serve(args)
    verify(params, cfg, args)
    return s


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--engine", choices=("continuous",), default="continuous")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--request-rate", type=float, default=4.0,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--num-requests", type=int, default=12)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--max-seq-len", type=int, default=256)
    ap.add_argument("--kv-quant", default=None,
                    help="page codebook QuantSpec (kmeans_ls@16)")
    ap.add_argument("--quantize", default=None,
                    help="PTQ the projections with this QuantSpec "
                         "(kmeans_ls@16; a bare method name combines with "
                         "--num-values)")
    ap.add_argument("--num-values", type=int, default=16)
    ap.add_argument("--attn-impl", choices=("auto", "fused", "gather"),
                    default="auto",
                    help="read path: the paged-attention kernel vs dense "
                         "gather (auto: fused on CUDA)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="admit prompts in N-token chunks, one per engine "
                         "iteration, interleaved with decode steps")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.request_rate <= 0:
        ap.error("--request-rate must be > 0 (requests per second)")
    if args.prefill_chunk is not None and args.prefill_chunk < 1:
        ap.error("--prefill-chunk must be >= 1 token")
    return args


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
