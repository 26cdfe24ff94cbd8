"""What page freezing costs a served trace: ``chip_smoke.py``'s main-path
trace (qwen3-0.6B, full width and depth, PTQ'd kmeans_ls@16 weights served
from codes) served with kmeans_ls@16 and with iter_l1@16 KV pages, in
turns in one process (the weights PTQ'd once), printing per run the TPOT
p50/p99 and the host's time inside the engine's decode steps and inside
the freeze dispatches they make (``dispatch_freeze``: the sketch, the
solve and the refit are enqueued there, on the side stream). One JSON
line per run. Needs one NVIDIA GPU.

    python3 tools/freeze_serve_probe.py
    python3 tools/freeze_serve_probe.py --order iter_l1@16 kmeans_ls@16

It uses only the launcher, the engine's worker and ``chip_smoke.py``'s
trace, so a copy of ``tools/`` times an older checkout the same way:
unpack the checkout with ``git archive`` into ``cmp/`` and run the copy
from its root.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (puts this checkout's src/ on the path)
import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--order", nargs="+", default=[
        "kmeans_ls@16", "iter_l1@16", "iter_l1@16", "kmeans_ls@16"])
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("freeze_serve_probe: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.serving import workers

    build.load_all(("paged_attention", "quant_matmul", "fista_quant"))
    timers = {}

    def timed(owner, name):
        inner = getattr(owner, name)

        def call(*a, **k):
            t0 = time.perf_counter()
            out = inner(*a, **k)
            n, t = timers.get(name, (0, 0.0))
            timers[name] = (n + 1, t + time.perf_counter() - t0)
            return out

        setattr(owner, name, call)

    timed(workers.DecodeWorker, "step")
    timed(workers, "dispatch_freeze")
    card = chip_smoke.card_line()
    params = None
    for kv in opts.order:
        timers.clear()
        args = serve.parse_args(chip_smoke.QUANT_ARGS + ["--kv-quant", kv])
        s, params, _ = serve.serve(args, params)
        print(json.dumps({
            "kv": kv, "tpot_p50_ms": s["tpot_p50_s"] * 1e3,
            "tpot_p99_ms": s["tpot_p99_s"] * 1e3,
            "freeze_dispatches": s["freeze_dispatches"],
            "host_ms": {k: (n, t * 1e3) for k, (n, t) in timers.items()},
            "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
