"""Readings behind the replay limits of ``chip_smoke.py`` and the
launcher: the fused-vs-gather and the chunked-vs-single replays at full
width and depth on the card, from kmeans_ls@16-PTQ'd weights as in
``chip_smoke.py``'s serve phases, for several prompt seeds, printed
without a bound. Run from a copy of the repository with one line of
``src/`` changed to read a planted fault.

    python3 tools/replay_readings.py --kv-quant iter_l1@16 --seeds 0 1 2
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (puts this checkout's src/ on the path)
import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kv-quant", default="iter_l1@16")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--no-chunked", action="store_true",
                    help="fused vs gather only")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("replay_readings: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    args = serve.parse_args(chip_smoke.QUANT_ARGS
                            + ["--kv-quant", opts.kv_quant])
    cfg = get_config(args.arch)
    params = models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    params, _ = serve.quantize_params(params, args, torch.device("cuda"))
    p32, c32 = serve.f32_copy(params, cfg)
    print(chip_smoke.card_line())
    for seed in opts.seeds:
        args.seed = seed
        r = chip_smoke.fused_vs_gather(p32, c32, args, opts.kv_quant)
        print(f"seed {seed} fused vs gather kv={opts.kv_quant}: rel "
              f"{r['rel']:.4%} max|dlogit| {r['dmax']:.4g} tokens "
              f"{r['agree']}/{r['total']}", flush=True)
        if not opts.no_chunked:
            r = serve.chunked_replay(params, cfg, args, opts.kv_quant)
            print(f"seed {seed} chunked vs single kv={opts.kv_quant}: rel "
                  f"{r['rel']:.4%} max|dlogit| {r['dmax']:.4g} tokens "
                  f"{r['agree']}/{r['total']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
