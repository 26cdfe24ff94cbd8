"""Where the dequant kernel's time goes: ``quant_matmul`` (bf16, uint8
codes, L = 16) at the given (G, M, K, N) shapes, timed on the device with
the L2 flushed before each call (each projection finds its codes cold, as
on the serve path) and warm (the same call repeated, the codes in L2),
beside a plain read of the codes (``torch.sum`` over them as int32 words),
both ways; and the host's time per call of the wrapper (G = 1: the flat
``quant_matmul`` the serve path calls). One JSON line per shape. With
``--sweep`` it also times, cold, every split count S of K (1-8, whole steps
a split) in place of the plan's. Needs one NVIDIA GPU.

    python3 tools/qmm_probe.py                  # the main path's shapes
    python3 tools/qmm_probe.py --sweep --shapes 1,4,1024,3072 28,4,1024,3072

Without ``--sweep`` it uses only the wrappers and ``chip_smoke.py``'s
helpers, so a copy of it times an older checkout's kernel the same way.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (puts this checkout's src/ on the path)
import numpy as np  # noqa: E402
import torch  # noqa: E402

MAIN = [f"1,{M},{K},{N}" for M in (4, 64) for K, N in
        sorted(set(chip_smoke.PROJ_SHAPES))]


def host_us(fn, *, calls=200, reps=25) -> tuple[float, float]:
    """The host's time of one call, in us: ``calls`` calls enqueued back to
    back after a sync (fewer than the launch queue holds, so none waits for
    the device), on the CPU clock; the median and the least of ``reps``
    (the least is the one other work on the host disturbed least)."""
    for _ in range(calls):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return float(np.median(times)), float(np.min(times))


def sweep(x, idx, cb, flush, reps) -> dict:
    """Cold time of the kernel under every whole-step split of K, through
    the wrapper with the plan replaced."""
    from repro_torch.kernels import quant_matmul_stacked

    qmm = importlib.import_module("repro_torch.kernels.quant_matmul")
    K, N = idx.shape[1:]
    steps = -(-K // qmm.BK)
    res = {}
    for S in range(1, qmm.MAX_SPLITS + 1):
        sps = -(-steps // S)
        if -(-steps // sps) != S:
            continue                    # not whole steps per split
        pl = qmm.QmmPlan(qmm.BN, qmm.BK, S, sps, -(-N // qmm.BN))
        res[f"S{S}x{sps}"] = chip_smoke.time_ms(
            lambda: qmm._launch(quant_matmul_stacked, x, idx, cb, None, pl),
            reps=reps, flush=flush)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=MAIN,
                    help="G,M,K,N quadruples")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sweep", action="store_true")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("qmm_probe: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import quant_matmul, quant_matmul_stacked

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    card = chip_smoke.card_line()
    for shape in opts.shapes:
        G, M, K, N = (int(v) for v in shape.split(","))
        x, idx, cb = chip_smoke.qmm_inputs(gen, M, K, N, torch.bfloat16, G=G)
        x0, idx0, cb0 = x[0], idx[0], cb[0]
        words = idx.view(torch.int32) if N % 4 == 0 else idx
        fns = {"kernel": lambda: quant_matmul_stacked(x, idx, cb),
               "read_codes": lambda: torch.sum(words, dtype=torch.int64)}
        row = {"G": G, "M": M, "K": K, "N": N}
        for name, fn in fns.items():
            row[f"{name}_cold_ms"] = chip_smoke.time_ms(
                fn, reps=opts.reps, flush=flush)
            row[f"{name}_warm_ms"] = chip_smoke.time_ms(fn, reps=opts.reps)
        row["host_us_per_call"], row["host_us_per_call_min"] = host_us(
            (lambda: quant_matmul(x0, idx0, cb0)) if G == 1 else fns["kernel"])
        if opts.sweep:
            row["sweep_cold_ms"] = sweep(x, idx, cb, flush, opts.reps)
        row["bound_ms"], row["bound_by"] = chip_smoke.qmm_bound(x, idx, cb)
        row["card"] = card
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
