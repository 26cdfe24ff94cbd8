"""Command line of the lint suite: ``python -m repro_torch.analysis
[paths...]`` (port of ``repro/analysis/__main__.py``).

Runs the registered passes over the given files and directories (default
``src/repro_torch``), subtracts the port's committed baseline
(``baseline.json`` beside this module; the repository root's
``analysis-baseline.json`` is the reference's), and exits 1 on any new
finding.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .lint import (all_passes, iter_python_files, load_baseline, Module,
                   partition_baseline, run_passes, save_baseline)

#: the port's baseline: accepted findings, none of them under serving/ or
#: kernels/
BASELINE = Path(__file__).with_name("baseline.json")

_EPILOG = """\
pragma syntax (suppression must carry a reason):

    nxt = last.argmax(-1).cpu().numpy()  # lint: sync(step-end token sync)

  # lint: <pass>(<reason>)[, <pass>(<reason>)...]

A pragma suppresses that pass's findings on its own line and the line
directly below it (so it can sit alone above a long statement).  Pragmas
with an empty reason (LINT001), an unknown pass name (LINT002), or that
suppress nothing (LINT003) are themselves findings.

baseline workflow:

  findings already accepted live in the baseline (fingerprints, free of
  line numbers; by default src/repro_torch/analysis/baseline.json); only
  new findings fail. Regenerate it with --write-baseline after review. It
  must stay empty for src/repro_torch/serving and src/repro_torch/kernels:
  a finding there is repaired or carries a pragma with its reason, never
  baselined.
"""


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static-analysis suite: host-sync check, "
                    "async-span lifecycle check, counter-name check "
                    "(stdlib ast only).",
        epilog=_EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to scan (default: "
                         "src/repro_torch)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--baseline", default=str(BASELINE),
                    help="committed fingerprint file (missing = empty; "
                         "default: the port's own)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept current findings into the baseline file")
    ap.add_argument("--passes", default=None,
                    help="comma-separated subset of passes to run")
    ap.add_argument("--list-passes", action="store_true")
    args = ap.parse_args(argv)

    registry = all_passes()
    if args.list_passes:
        for name, cls in sorted(registry.items()):
            print(f"{name:10s} {cls.description}")
        return 0

    if args.passes:
        unknown = [p for p in args.passes.split(",")
                   if p not in registry]
        if unknown:
            ap.error(f"unknown pass(es): {', '.join(unknown)} "
                     f"(known: {', '.join(sorted(registry))})")
        classes = [registry[p] for p in args.passes.split(",")]
    else:
        classes = list(registry.values())

    modules = [Module.load(p, rel)
               for p, rel in iter_python_files(args.paths)]
    findings = run_passes(modules, classes)

    baseline_path = Path(args.baseline)
    if args.write_baseline:
        save_baseline(baseline_path, findings)
        print(f"[analysis] wrote {len(findings)} fingerprint(s) to "
              f"{baseline_path}")
        return 0

    baseline = load_baseline(baseline_path)
    new, old = partition_baseline(findings, baseline)

    if args.format == "json":
        print(json.dumps({
            "scanned_files": len(modules),
            "passes": [c.name for c in classes],
            "new": [f.to_json() for f in new],
            "baselined": [f.to_json() for f in old],
        }, indent=2))
    else:
        for f in new:
            print(f.render())
        tail = (f"[analysis] {len(modules)} files, "
                f"{len(new)} new finding(s), {len(old)} baselined")
        print(tail, file=sys.stderr if new else sys.stdout)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
