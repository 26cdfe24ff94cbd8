#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch/CUDA port once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell (an entry of ``workloads`` in
``BENCHMARK.json``) names a configuration (``portbench/configs/<name>.json``)
and a traffic mix (``portbench/traffic/<name>.json``); the mix's
``driver`` (``portbench/drivers/<driver>.py``) makes the weights and
inputs from the seed, sets up and warms up the program, runs the window
of ``--seconds`` and has the plain reference judge what it produced.

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` also
records the program's spans and a device profile of a fixed span of the
window, and prints the cell's per-layer metrics, each read by its reader
``portbench/metrics/<name before the first dot>.py``, with the device's
busy seconds and a breakdown. The last line of standard output is one
JSON object; the numbers compared with their limits are the last lines
of standard error and the last key of that object.

The run needs as many CUDA devices as the cell asks for. ``--cpu`` runs
the configuration's and the mix's ``cpu_dry_run`` sizes on the host (the
tests' dry run; no device metric is taken there); ``--control fp8`` puts
the control (the reference at fp8) in the program's place: its readings
are the ones judged against the limits, so it must come out not
correct; ``--rate`` replaces an open-loop mix's rate (the knee sweep).
"""
from __future__ import annotations

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
# every cache the program or the libraries write stays in the checkout, at
# fixed paths, so only a checkout's first run builds
CACHES = {"TRITON_CACHE_DIR": "build/portbench/triton",
          "TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions",
          "CUDA_CACHE_PATH": "build/portbench/cuda_cache"}


def _fail(msg: str, code: int) -> None:
    print(f"[portbench] {msg}", file=sys.stderr)
    raise SystemExit(code)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="the cpu_dry_run sizes on the host")
    ap.add_argument("--control", choices=("fp8",), default=None)
    ap.add_argument("--rate", type=float, default=None,
                    help="an open-loop mix's rate, requests/s")
    return ap.parse_args(argv)


def _reader(name: str):
    """The reader of per-layer metric ``name``: the module
    ``portbench/metrics/<name before the first dot>.py``."""
    base = name.split(".", 1)[0]
    path = BENCH / "metrics" / f"{base}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{base}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def run(args) -> tuple[dict, dict | None]:
    """The result object of one run (see the module doc) and the driver's
    notes (what it saw of the window beside the metrics)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        _fail(f"no workload {args.workload!r} in BENCHMARK.json", 2)
    wl = cells[args.workload]
    for k, v in CACHES.items():
        os.environ[k] = str(ROOT / v)
    os.environ["USE_FLAX"] = "0"
    import torch

    if not args.cpu and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < wl["chips"]):
        _fail(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", 3)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench.yardstick import endtoend, traffic
    from portbench.yardstick.imports import forbidden_loaded

    config = json.loads((BENCH / "configs" / f"{wl['config']}.json")
                        .read_text())
    mix = traffic.load_mix(wl["traffic"])
    limits = json.loads((BENCH / "checks" / f"{wl['name']}.json")
                        .read_text())
    dry = limits.pop("cpu_dry_run")
    if args.cpu:
        mix.update(mix["cpu_dry_run"])
        limits = dry
    if args.rate is not None:
        mix["rate_rps"] = args.rate
    torch.set_num_threads(4)
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    job = {"workload": wl, "config": config, "mix": mix, "seed": args.seed,
           "seconds": args.seconds, "trace": bool(args.trace),
           "cpu": args.cpu, "control": args.control, "t_proc": T_PROC}
    out = driver.run(job)
    out.update(mix=mix, config=config, workload=wl["name"])

    metrics = {}
    if not args.trace:
        for m in bench["end_to_end"]:
            if _applies(m, wl["name"]):
                metrics[m["name"]] = {"value": endtoend.METRICS[m["name"]](
                    out), "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if _applies(m, wl["name"]):
                v = _reader(m["name"])(out)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if args.cpu:
        device = {"platform": "cpu", "kind": "cpu", "count": 0,
                  "memory_peak_bytes": 0}
    else:
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": wl["chips"],
                  "memory_peak_bytes": out["memory_peak"]}
    result = {"correct": None, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    dtr = out.get("device_trace")
    if args.trace and dtr is not None:
        device["busy_s"] = dtr["busy_s"]
        device["window_s"] = dtr["window_s"]
        result["breakdown"] = {"device_ops": dtr["device_ops"],
                               "idle_gaps": dtr["idle_gaps"]}
    got = out["check"]
    if args.control:
        # the control in the program's place: its readings are judged by
        # the same test, and the program's go to the notes
        out.setdefault("notes", {})["program_checks"] = {
            k: v for k, v in got.items() if not k.startswith("control_")}
        got = {k[8:]: v for k, v in got.items() if k.startswith("control_")}
    missing = set(limits) - set(got)
    if missing:
        _fail(f"the reference gave no {', '.join(sorted(missing))}", 5)
    checks = {name: {"value": got[name], "limit": lim}
              for name, lim in limits.items()}
    checks["failed"] = {"value": out["failed"], "limit": 0}
    result["correct"] = all(c["value"] <= c["limit"]
                            for c in checks.values())
    result["checks"] = checks
    found = forbidden_loaded()
    if found:
        _fail(f"the run loaded {', '.join(found)}", 4)
    return result, out.get("notes")


def main(argv=None) -> None:
    result, notes = run(parse_args(argv))
    if notes:
        print(f"[portbench] notes {json.dumps(notes)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"[portbench] check {name}: {c['value']!r} "
              f"(limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
