"""Trace a serving run of the PyTorch port and open it in Perfetto: attach
a ``Tracer`` and a ``MetricsExporter`` to the disaggregated speculative
engine, write Chrome-trace JSON, and reconcile the trace with the
engine's counters.

    PYTHONPATH=src python examples/torch_trace_serving.py [--device cpu] \\
        [--out DIR]

Then load DIR/trace.json at https://ui.perfetto.dev (or chrome://tracing):
one labelled lane per component (router decisions, prefill dispatch and
harvest, decode-step phases, transfer extract/splice with the wire
bytes, the page-freeze lifecycle, speculative propose/verify/accept/
rollback). Spans are on the host's clock: on the card they time the
enqueue, and ``sync`` absorbs the queued device time.

CLI equivalent (any engine flags compose with the observability ones)::

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \\
        --engine disagg --speculate 2 --kv-quant kmeans_ls@16 \\
        --migrate frozen --trace-out trace.json --metrics-jsonl m.jsonl

Returns (``main``) the trace's and the counters' readings; it fails
unless they reconcile (``launch.serve._trace_reconcile``'s checks).
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import get_reduced_config
from repro_torch.device import resolve_device, where
from repro_torch.launch.serve import _trace_reconcile
from repro_torch.obs import MetricsExporter, Tracer, prometheus_text
from repro_torch.serving import DisaggEngine, derive_draft, make_requests

B, PROMPT_LEN, GEN, SPECULATE = 4, 16, 12, 2


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    ap.add_argument("--out", default=".",
                    help="where trace.json and metrics.jsonl go")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = where(dev)
    os.makedirs(args.out, exist_ok=True)
    trace_path = os.path.join(args.out, "trace.json")
    metrics_path = os.path.join(args.out, "metrics.jsonl")

    cfg = get_reduced_config("qwen3_0_6b")
    params = models.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, PROMPT_LEN).tolist()
               for _ in range(B)]

    tracer = Tracer()                          # perf_counter clock
    exporter = MetricsExporter(metrics_path, interval_s=0.25)
    eng = DisaggEngine(params, cfg, device=dev, prefill_workers=1,
                       decode_workers=1, migrate="frozen",
                       kv_quant="kmeans_ls@16", speculate=SPECULATE,
                       draft=derive_draft(params, cfg), max_slots=B,
                       block_size=8, max_seq_len=PROMPT_LEN + GEN + 4,
                       tracer=tracer, exporter=exporter)
    s = eng.run(make_requests(prompts, GEN))
    exporter.close(eng.metrics)

    tracer.write(trace_path)
    with open(trace_path) as f:
        d = json.load(f)
    tracks = sorted(e["args"]["name"] for e in d["traceEvents"]
                    if e["ph"] == "M" and e["name"] == "thread_name")
    print(f"{trace_path}: {len(d['traceEvents'])} events on tracks {tracks}")
    print("  -> load at https://ui.perfetto.dev")

    # the trace is not just pictures: it reconciles with the counters
    ok = _trace_reconcile(tracer, s, SPECULATE)
    if not ok:
        raise SystemExit("trace/counter reconciliation failed")
    print(f"reconciled: {s['decode_steps']} decode steps, "
          f"{s['freeze_dispatches']} freeze flushes, {s['spec_steps']} "
          f"verify slices against the trace; {s['paged_attention_launches']}"
          f" paged-attention kernel launches on {card}")

    # metrics.jsonl holds periodic snapshots (windowed p50/p99 per
    # histogram); the same snapshot renders as Prometheus text
    with open(metrics_path) as f:
        rows = [json.loads(ln) for ln in f]
    print(f"{metrics_path}: {len(rows)} snapshots; final gen_tokens="
          f"{rows[-1]['gen_tokens']}")
    print(prometheus_text(eng.metrics.snapshot()).splitlines()[0])
    return {"device": dev.type, "card": card, "reconciled": ok,
            "events": len(d["traceEvents"]), "tracks": tracks,
            "decode_steps": s["decode_steps"],
            "freeze_dispatches": s["freeze_dispatches"],
            "spec_steps": s["spec_steps"], "snapshots": len(rows),
            "gen_tokens": rows[-1]["gen_tokens"],
            "completed": s["completed"],
            "paged_attention_launches": s["paged_attention_launches"],
            "attn_impl": s["attn_impl"], "trace_path": trace_path}


if __name__ == "__main__":
    main(sys.argv[1:])
