"""What the quantized-KV serving check reads as one factor changes at a
time: ``chip_smoke.py``'s wide-config phases (full width, the depth cut
to 4 layers, dense bf16 seeded weights, kmeans_ls@16 pages, the same
replay prompts) read with the page size and the final logit softcap
varied on the same weights. One JSON line per run: the page row's value
count (block x kv heads x head_dim: the values one codebook covers), the
largest |logit|, max |dlogit| and their ratio (the check's ``rel``, limit
8%), greedy-token agreement. Needs one NVIDIA GPU.

    python3 tools/serving_check_probe.py
    python3 tools/serving_check_probe.py --runs gemma2_27b,16,on yi_34b,32,on

A run is ``arch,block,softcap``: ``softcap`` ``on`` keeps the config's
final softcap, ``off`` drops it (the weights are the same either way).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (puts this checkout's src/ on the path)
import torch  # noqa: E402

RUNS = ["gemma2_27b,16,on", "gemma2_27b,16,off", "gemma2_27b,8,on",
        "gemma2_27b,8,off", "yi_34b,16,on", "yi_34b,32,on"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", nargs="+", default=RUNS)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serving_check_probe: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import serve

    build.load_all(("paged_attention",))
    card = chip_smoke.card_line()
    weights = {}
    for run in opts.runs:
        arch, block, cap = run.split(",")
        args = serve.parse_args(chip_smoke.WIDE_ARGS + [
            "--arch", arch, "--block-size", block])
        cfg = serve.cut_depth(get_config(arch), args.layers)
        if arch not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            # as serve() makes them: the same seed, the same weights
            weights[arch] = models.init_params(
                cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        if cap == "off":
            cfg = dataclasses.replace(cfg, final_softcap=None)
        t0 = time.perf_counter()
        r = serve.serving_replay(weights[arch], cfg, args)
        print(json.dumps({
            "arch": arch, "layers": cfg.n_layers, "block": int(block),
            "final_softcap": cfg.final_softcap,
            "row_values": int(block) * cfg.n_kv_heads * cfg.head_dim,
            "max_abs_logit": r["scale"], "max_abs_dlogit": r["dmax"],
            "mean_abs_dlogit": r["dmean"], "rel": r["rel"],
            "agree": f"{r['agree']}/{r['total']}",
            "installs": r["installs"],
            "s": time.perf_counter() - t0, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
