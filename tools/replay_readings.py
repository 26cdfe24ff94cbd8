"""Readings behind the replay limits of ``chip_smoke.py`` and the
launcher: the fused-vs-gather and the chunked-vs-single replays at full
width and depth on the card, from kmeans_ls@16-PTQ'd weights as in
``chip_smoke.py``'s serve phases, for several prompt seeds, printed
without a bound. With ``--speculate``, the serve-spec phase's replays
instead: speculative vs non-speculative (with the auto draft and with
``chip_smoke.untied_draft``, which rolls back), shared vs unshared prefix
(fp pool) and fused vs gather of speculative engines. With ``--disagg``,
the disaggregated engine against the colocated one on an fp pool (f32,
``chip_smoke.DISAGG_ARGS``) instead. Run from a copy of the repository
with one line of ``src/`` changed to read a planted fault.

    python3 tools/replay_readings.py --kv-quant iter_l1@16 --seeds 0 1 2
    python3 tools/replay_readings.py --kv-quant kmeans_ls@16 --speculate
    python3 tools/replay_readings.py --disagg
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
    ap.add_argument("--speculate", action="store_true",
                    help="the serve-spec phase's replays (chip_smoke."
                         "SPEC_ARGS) instead")
    ap.add_argument("--disagg", action="store_true",
                    help="disagg vs colocated on an fp pool (chip_smoke."
                         "DISAGG_ARGS) instead")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("replay_readings: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    args = serve.parse_args((chip_smoke.SPEC_ARGS if opts.speculate
                             else chip_smoke.DISAGG_ARGS if opts.disagg
                             else chip_smoke.QUANT_ARGS)
                            + ["--kv-quant", opts.kv_quant])
    cfg = get_config(args.arch)
    params = models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    params, _ = serve.quantize_params(params, args, torch.device("cuda"))
    p32, c32 = serve.f32_copy(params, cfg)
    print(chip_smoke.card_line())
    for seed in opts.seeds:
        args.seed = seed
        if opts.disagg:
            r = serve.disagg_replay(params, cfg, args)
            print(f"seed {seed} disagg vs colocated (fp pool): rel "
                  f"{r['rel']:.4%} max|dlogit| {r['dmax']:.4g} tokens "
                  f"{r['agree']}/{r['total']} "
                  f"{'equal' if r['tokens_equal'] else 'DIFFER'} "
                  f"handoffs {r['handoffs']}", flush=True)
            continue
        if opts.speculate:
            for name, fn in (
                    ("speculative vs non-speculative (auto draft)",
                     serve.speculative_replay),
                    ("speculative vs non-speculative (untied draft)",
                     lambda *a: serve.speculative_replay(
                         *a, chip_smoke.untied_draft)),
                    ("shared vs unshared (fp pool)", serve.prefix_replay)):
                r = fn(params, cfg, args)
                extra = {k: r[k] for k in ("acceptance", "rollbacks",
                                           "prefix_hits",
                                           "prefix_shared_pages") if k in r}
                print(f"seed {seed} {name} kv={opts.kv_quant}: rel "
                      f"{r['rel']:.4%} max|dlogit| {r['dmax']:.4g} tokens "
                      f"{r['agree']}/{r['total']} "
                      f"{'equal' if r['tokens_equal'] else 'DIFFER'} "
                      f"{extra}", flush=True)
        r = chip_smoke.fused_vs_gather(p32, c32, args, opts.kv_quant)
        print(f"seed {seed} fused vs gather kv={opts.kv_quant}: rel "
              f"{r['rel']:.4%} max|dlogit| {r['dmax']:.4g} tokens "
              f"{r['agree']}/{r['total']}", flush=True)
        if not (opts.no_chunked or opts.speculate):
            r = serve.chunked_replay(params, cfg, args, opts.kv_quant)
            print(f"seed {seed} chunked vs single kv={opts.kv_quant}: rel "
                  f"{r['rel']:.4%} max|dlogit| {r['dmax']:.4g} tokens "
                  f"{r['agree']}/{r['total']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
