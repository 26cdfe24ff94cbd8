"""Quantized serving on the PyTorch port: PTQ a small LM with the paper's
solver, decode a batch with dense vs value-shared weights, price the
decode step at the H100's HBM rate, then serve disaggregated with frozen
KV page migration.

    PYTHONPATH=src python examples/torch_serve_quantized.py [--device cpu]

The model is the reduced qwen3 (seeded random weights). On the card the
decode workers read their frozen pages through the paged-attention
kernel. CLI equivalent of the last part (plus --prefill-workers and
--decode-workers, --freeze-page-budget, --temperature/--top-k; see
``python -m repro_torch.launch.serve --help``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \\
        --engine disagg --kv-quant kmeans_ls@16 --migrate frozen

Returns (``main``) the compression, the decode agreement, the estimate
and the handoff's bytes.
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import get_reduced_config
from repro_torch.device import resolve_device, where
from repro_torch.quant import (compression_ratio, dequantize_tree,
                               estimate_decode_bytes, quantize_tree)
from repro_torch.serving import DisaggEngine, make_requests

PTQ_SPEC = "kmeans_ls@16:weighted=true"
B, PROMPT_LEN, GEN = 4, 16, 12


def prompts_for(cfg) -> np.ndarray:
    """The batch's prompts: (B, PROMPT_LEN) tokens from numpy seed 1."""
    return np.random.default_rng(1).integers(
        0, cfg.vocab, (B, PROMPT_LEN)).astype(np.int64)


def generate(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Greedy decode of GEN tokens after one prefill, on the dense ring
    cache: (B, GEN) tokens."""
    cache = models.init_cache(cfg, B, PROMPT_LEN + GEN, tokens.device)
    logits, cache = models.prefill(params, cfg, {"tokens": tokens}, cache)
    tok = logits[:, -1:].argmax(-1)
    out = [tok]
    for i in range(GEN - 1):
        logits, cache = models.decode_step(params, cfg, tok, cache,
                                           PROMPT_LEN + i)
        tok = logits[:, -1:].argmax(-1)
        out.append(tok)
    return torch.cat(out, dim=1)


def main(argv=None, *, params=None) -> dict:
    """``params``: the reduced qwen3's weights on the device (default:
    seeded random ones)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = where(dev)

    cfg = get_reduced_config("qwen3_0_6b")
    if params is None:
        params = models.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)

    # PTQ with the paper's Algorithm 3 (k-means + least squares), 16
    # values a tensor
    qtree, report = quantize_tree(params, PTQ_SPEC)
    ratio = compression_ratio(report)
    print(f"quantized {len(report)} tensors; compression {ratio:.1f}x")
    params_q = dequantize_tree(qtree)

    prompts = prompts_for(cfg)
    tokens = torch.from_numpy(prompts).to(dev)
    dense_out = generate(params, cfg, tokens)
    quant_out = generate(params_q, cfg, tokens)
    agree = float((dense_out == quant_out).float().mean())
    print(f"decode agreement dense vs 16-value quantized: {agree * 100:.0f}% "
          f"({GEN} tokens x {B} requests) on {card}")

    # roofline estimate of the decode step on the H100 (decode reads every
    # weight once a step: HBM-bound)
    n_params = models.param_count(params)
    est = estimate_decode_bytes(n_params * 2, ratio, cache_bytes=0)
    print(f"H100 decode-step estimate (HBM 3.35 TB/s): dense "
          f"{est['t_dense_s'] * 1e6:.4f}us -> quantized "
          f"{est['t_quant_s'] * 1e6:.4f}us ({est['speedup']:.2f}x "
          f"weight-read speedup)")

    # --- disaggregated serving with frozen KV page migration -------------
    # prompts run on a prefill worker; each full page crosses to the
    # decode worker as packed 4-bit codes + its codebooks
    eng = DisaggEngine(params, cfg, device=dev, prefill_workers=1,
                       decode_workers=1, migrate="frozen",
                       kv_quant="kmeans_ls@16", max_slots=B, block_size=16,
                       max_seq_len=PROMPT_LEN + GEN + 16)
    s = eng.run(make_requests(prompts.tolist(), GEN))
    c = eng.decode[0].counters
    moved, fp = c["migrate_bytes"], c["migrate_fp_equiv_bytes"]
    print(f"disagg serve: {s['completed']} requests, prefill->decode "
          f"handoff moved {moved / 1e3:.1f} kB as codes+codebooks (fp rows "
          f"would be {fp / 1e3:.1f} kB, {fp / max(moved, 1):.1f}x more), "
          f"{c['host_page_solves']} host page solves, "
          f"{s['paged_attention_launches']} paged-attention kernel "
          f"launches on {card}")
    return {"device": dev.type, "card": card, "ptq_tensors": len(report),
            "compression": ratio, "agreement": agree,
            "dense_tokens": dense_out.cpu().numpy(),
            "quant_tokens": quant_out.cpu().numpy(), "n_params": n_params,
            "estimate": est, "completed": s["completed"],
            "migrate_bytes": moved, "migrate_fp_equiv_bytes": fp,
            "migrated_pages": c["migrated_pages"],
            "host_page_solves": c["host_page_solves"],
            "paged_attention_launches": s["paged_attention_launches"],
            "attn_impl": s["attn_impl"]}


if __name__ == "__main__":
    main(sys.argv[1:])
