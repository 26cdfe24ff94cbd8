"""Where kernel 4's time goes: ``fista_quant`` at the page freeze's shape
(224 sketched rows of 128 columns, 100 steps, at a lambda halfway to each
row's lam_hi) and at batched PTQ's (7 rows of 4096, 1000 steps, the
reference kernel test's inputs), timed on the device with the L2 flushed
before each call (cold) and without (warm); then one page freeze,
``quantize_pages_fista`` on 224 rows of 16 x 8 x 128 values: its device
busy time and kernel count from the profiler's kernel records, its time
between CUDA events, its FISTA kernel launches and the host's time of the
call (it returns before the device is done). One JSON line per shape.
Needs one NVIDIA GPU.

    python3 tools/fista_probe.py

It uses only the wrappers, ``chip_smoke.py``'s helpers and
``qmm_probe.host_us``, so a copy of ``tools/`` times an older checkout the
same way: unpack the checkout with ``git archive`` into ``cmp/`` and run
the copy from its root.
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


def device_busy(fn, n=5) -> tuple[float, float]:
    """Device busy time of one call in us (the sum of its kernels'
    durations in the profiler's records) and its kernel count, the
    median over n calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    busy, count = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        busy.append(sum(spans))
        count.append(len(spans))
    return float(np.median(busy)), float(np.median(count))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fista_probe: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.kernels import (fista_quant, power_iter_lipschitz,
                                     quantize_pages_fista)

    fq = importlib.import_module("repro_torch.kernels.fista_quant")
    card = chip_smoke.card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    page = chip_smoke.fista_page_inputs(gen)
    w = torch.sort(torch.randn(7, 4096, generator=gen, device="cuda"),
                   dim=1).values
    d = torch.diff(w, dim=1, prepend=torch.zeros(7, 1, device="cuda"))
    n = torch.ones_like(w)
    eta = (1.0 / (power_iter_lipschitz(d, n) * 1.01)).float()
    ptq = tuple(a.reshape(7, 32, 128) for a in (
        w, d, n, torch.full_like(w, 0.05))) + (eta.reshape(7, 1, 1),)
    for name, args, n_iters in (("page", page, 100), ("ptq", ptq, 1000)):
        call = lambda: fista_quant(*args, n_iters=n_iters)
        reps = opts.reps if name == "page" else max(opts.reps // 2, 1)
        row = {"shape": name, "rows": tuple(args[0].shape),
               "n_iters": n_iters,
               "cold_ms": chip_smoke.time_ms(call, reps=reps, flush=flush),
               "warm_ms": chip_smoke.time_ms(call, reps=reps)}
        Mp = args[0].shape[1] * args[0].shape[2]
        if hasattr(fq, "plan"):
            row["plan"] = fq.plan(Mp)._asdict()
        row["card"] = card
        print(json.dumps(row), flush=True)

    E = chip_smoke.SHAPES["bs"] * chip_smoke.SHAPES["Hkv"] * \
        chip_smoke.SHAPES["Dh"]
    rows = torch.randn(224, E, generator=gen, device="cuda")
    rows[::3] *= torch.linspace(0.1, 3.0, E, device="cuda")
    freeze = lambda: quantize_pages_fista(rows, num_values=16)
    entries = [k for k in (getattr(kernels, "fista_freeze", None),
                           fista_quant) if k is not None]
    freeze()
    torch.cuda.synchronize()
    before = sum(k.launches for k in entries)
    freeze()
    torch.cuda.synchronize()
    row = {"shape": "freeze", "rows": tuple(rows.shape),
           "fista_launches": sum(k.launches for k in entries) - before}
    row["device_busy_us"], row["kernels"] = device_busy(freeze)
    row["events_ms"] = chip_smoke.time_ms(freeze, reps=10, flush=flush)
    row["host_us"], row["host_us_min"] = host_us(freeze, calls=1, reps=20)
    row["card"] = card
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
