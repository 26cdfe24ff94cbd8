"""Readings of a cell with a fault planted in the program, at the cell's
own size: what the limits' upper readings are set from (``PERF.md``).

    python3 portbench/tests/fault_readings.py --fault half_batch \\
        --workload qwen3-0.6b.train --seed 7 --seconds 2

prints the run's result line with its checks. Faults: ``half_batch``
(each train step sees the first half of its rows, the mean over them),
``unchanged`` (each train step returns the state it was given),
``token`` (every third decode step's greedy token of the first row
moves one id up, where the logits are produced), ``next_codebook``
(every frozen KV page is installed with the codebooks of the next page
frozen with it, or of the next layer where a page freezes alone, so
both read paths serve wrong values from then on). ``--cpu`` runs the
dry-run sizes, as the tests do."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def plant(fault: str, setattr=setattr):
    """Plant ``fault`` in the program by replacing a module attribute
    through ``setattr`` (a test passes its monkeypatch's)."""
    if fault == "next_codebook":
        import torch
        from repro_torch.serving import kv_cache

        real_install = kv_cache._install

        def install(pool, jb, codes, cb):
            # cb (2, n_layers, pages, L): roll over pages, else layers
            dim = 2 if cb.shape[2] > 1 else 1
            real_install(pool, jb, codes, torch.roll(cb, -1, dims=dim))

        setattr(kv_cache, "_install", install)
        return
    if fault == "token":
        from repro_torch import models

        real, calls = models.decode_step, [0]

        def altered(*a, **k):
            logits, cache = real(*a, **k)
            calls[0] += 1
            if calls[0] % 3 == 0:
                row = logits[0, -1]
                row[(int(row.argmax()) + 1) % row.shape[0]] += 1e4
            return logits, cache

        setattr(models, "decode_step", altered)
        return
    from repro_torch.train import step as step_mod

    real_make = step_mod.make_train_step

    def make(cfg, *a, **k):
        fn, opt = real_make(cfg, *a, **k)

        def bad(state, batch):
            if fault == "unchanged":
                return state, fn(state, batch)[1]
            half = {n: t[: t.shape[0] // 2] for n, t in batch.items()}
            return fn(state, half)

        return bad, opt

    setattr(step_mod, "make_train_step", make)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fault", required=True,
                    choices=("half_batch", "unchanged", "token",
                             "next_codebook"))
    args, rest = ap.parse_known_args(argv)
    from portbench import run as bench

    plant(args.fault)
    result, notes = bench.run(bench.parse_args(rest))
    print(json.dumps({"fault": args.fault, "notes": notes, **result}))


if __name__ == "__main__":
    main()
