"""Where the paged-attention kernel's time goes: ``paged_decode_attention``
(bf16 pools, qwen3-0.6B's heads, block 16, half the pages frozen) at decode
steps of B sequences x n tokens and prefill chunks of C tokens at an
offset, timed on the device with the L2 flushed before each call (each
layer finds its pages cold, as on the serve path) and warm, beside gather +
``scaled_dot_product_attention`` on the same pool (cold); the device time
of one call from the profiler's kernel record (no event overhead); and the
host's time per call of the wrapper. One JSON line per shape. With
``--clusters`` it also times, cold, the kernel with the plan's cluster
replaced by each given size (the fold is in split order, so the output is
the same bits; the test suite checks that). Needs one NVIDIA GPU.

    python3 tools/pa_probe.py                       # the main path's shapes
    python3 tools/pa_probe.py --shapes decode,4,2048 --clusters 1 4 8

Without ``--clusters`` it uses only the wrapper, ``chip_smoke.py``'s pool
helpers and ``qmm_probe.host_us``, so a copy of ``tools/`` times an older
checkout's kernel the same way (its plan is printed where it has one):
unpack the checkout with ``git archive`` into ``cmp/`` and run the copy
from its root.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (puts this checkout's src/ on the path)
import numpy as np  # noqa: E402
import torch  # noqa: E402
from qmm_probe import host_us  # noqa: E402

MAIN = ["decode,4,16", "decode,4,65", "decode,4,272", "decode,4,512",
        "prefill,1,64,0", "prefill,1,64,192", "prefill,4,64,192"]


def device_us(fn, n=50) -> float:
    """Median device time of one call's kernel, in us, from the profiler's
    kernel records over n calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and "paged_attention_kernel" in e.name]
    return float(np.median(spans)) if spans else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=MAIN,
                    help="decode,B,n or prefill,B,C,offset")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--clusters", nargs="*", type=int, default=[])
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pa_probe: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import paged_decode_attention

    pa = importlib.import_module("repro_torch.kernels.paged_attention")
    pa_plan = getattr(chip_smoke, "pa_plan", None)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    Hq, Dh = chip_smoke.SHAPES["Hq"], chip_smoke.SHAPES["Dh"]
    card = chip_smoke.card_line()
    for shape in opts.shapes:
        kind, *nums = shape.split(",")
        if kind == "decode":
            B, n = (int(v) for v in nums)
            pool = chip_smoke.make_pool(gen, valid=[n] * B,
                                        dtype=torch.bfloat16)
            q = torch.randn(B, 1, Hq, Dh, generator=gen, device="cuda")
            W = 1
        else:
            B, W, off = (int(v) for v in nums)
            pool = chip_smoke.make_pool(gen, valid=[off + W] * B,
                                        dtype=torch.bfloat16)
            q = torch.randn(B, W, Hq, Dh, generator=gen, device="cuda")
        q = q.to(torch.bfloat16)
        args = (q, *chip_smoke.pool_args(pool), pool["kv_valid_len"])
        call = lambda: paged_decode_attention(*args, quantized=True)
        with_cluster = lambda c: pa._launch(
            *args, softcap=None, quantized=True, packed=True,
            pl=pa.plan(chip_smoke.SHAPES["bs"], Dh, torch.bfloat16)._replace(
                cluster=c))
        row = {"shape": shape,
               "plan": pa_plan and pa_plan(pool, W, torch.bfloat16)}
        row["cold_ms"] = chip_smoke.time_ms(call, reps=opts.reps, flush=flush)
        row["warm_ms"] = chip_smoke.time_ms(call, reps=opts.reps)
        row["device_us"] = device_us(call)
        row["library_cold_ms"] = chip_smoke.time_ms(
            lambda: chip_smoke.gather_sdpa(q, pool), reps=opts.reps,
            flush=flush)
        row["host_us_per_call"], row["host_us_per_call_min"] = host_us(call)
        row["clusters_cold_ms"] = {
            c: chip_smoke.time_ms(lambda: with_cluster(c), reps=opts.reps,
                                  flush=flush)
            for c in opts.clusters}
        row["card"] = card
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
