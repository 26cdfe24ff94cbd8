"""Multi-pod dry run (port of ``repro/launch/dryrun.py``): every (arch x
shape x mesh) cell's step run once on fake tensors over a fake process
group of 256 or 512 ranks, counted per device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_0_6b \\
        --shape train_4k [--multi-pod] [--out build/dryrun] [--save-hlo]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--jobs 4]

The process joins the fake group first (``launch.mesh.join_fake``), as
the reference sets ``XLA_FLAGS`` before jax starts; then
``make_production_mesh`` (16 x 16, or 2 x 16 x 16 with ``--multi-pod``)
spans it. Under ``FakeTensorMode`` the cell's state is built from the
step builders' specs and placed by the sharding rules
(``train_state_specs``, ``param_shardings``, ``cache_shardings``,
``batch_shardings``), and ``make_train_step`` (forward, backward and the
optimizer's update), ``make_prefill_step`` or ``make_decode_step`` runs
once inside ``analysis.hlo.accounting``, which counts what rank 0 runs:
FLOPs, HBM bytes, collective bytes and the peak bytes it holds. Nothing
is allocated and no device is needed. Each cell writes
``<arch>.<shape>.<mesh>.json`` with the reference's keys where torch has
the quantity: ``status``, ``n_devices``, ``params_total``,
``params_active``, ``memory`` (``argument_bytes``, ``output_bytes``,
``peak_estimate``), ``hlo.*`` and ``roofline`` (at the H100's rates);
``t_lower_s`` is the fake run's seconds. Dropped, having no meaning
here: ``t_compile_s`` (nothing compiles), ``hlo.while_trips`` (no
loops: the layers are a list), ``cost_analysis`` (XLA's), and
``memory``'s ``temp_bytes`` and ``alias_bytes`` (the peak is measured,
not summed). The port has no HLO: ``--save-hlo`` (the reference's flag,
kept so its command lines run) writes the counterpart, the op listing
``<arch>.<shape>.<mesh>.ops.gz`` beside the cell's JSON: one JSON line
per counted op in dispatch order (``analysis.hlo.op_lines``: the aten or
c10d name, the operands' dtypes and local shapes, FLOPs and f32 FLOPs,
HBM bytes, collective kind and bytes), whose columns sum to the cell's
``hlo`` totals and whose lines are its ``n_ops``. Cells that
``shape_skip_reason`` names are ``skipped``. ``--all`` runs each cell
in a subprocess, ``--jobs`` of them at a time.

Imports neither jax nor the reference package.
"""
from __future__ import annotations

import argparse
import gzip
import json
import logging
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import models
from repro_torch.analysis.hlo import _locals, _tensors, accounting, op_lines
from repro_torch.analysis.roofline import (Roofline, model_flops,
                                           model_params_active)
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import join_fake, make_production_mesh
from repro_torch.runtime.sharding import (batch_shardings, cache_shardings,
                                          distribute, param_shardings)
from repro_torch.train.step import (SHAPES, cache_specs, input_specs,
                                    make_decode_step, make_prefill_step,
                                    make_train_step, shape_skip_reason,
                                    train_state_specs)
from repro_torch.tree import tree_map

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "dryrun")


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def _fake(tree):
    """Meta tensors -> fake tensors of the same shapes and dtypes (inside
    ``FakeTensorMode``)."""
    return tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype), tree)


def lower_cell(arch: str, shape: str, *, multi_pod: bool, fake_mode):
    """Build one cell's state as fake tensors of ``fake_mode`` (a
    ``FakeTensorMode``), placed on the production mesh. Returns ``(run,
    held, cfg, mesh)``: ``run()``, called inside ``fake_mode``, runs the
    step once; ``held`` is what it reads (alive throughout)."""
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)   # outside fake_mode
    with fake_mode:
        return (*_place(cfg, mesh, shape), cfg, mesh)


def _place(cfg, mesh, shape) -> tuple:
    """(run, held) of ``lower_cell``, inside the fake mode."""
    kind = SHAPES[shape]["kind"]
    batch = {k: torch.zeros(s, dtype=d)
             for k, (s, d) in input_specs(cfg, shape).items()}
    batch = distribute(batch, mesh, batch_shardings(mesh, batch))
    if kind == "train":
        step, opt = make_train_step(cfg, mesh)
        state, shard = train_state_specs(cfg, mesh, opt)
        state = distribute(_fake(state), mesh, shard)
        return (lambda: step(state, batch)), (state, batch)
    params = _fake(models.init_params(cfg, torch.Generator(),
                                      torch.device("meta")))
    params = distribute(params, mesh, param_shardings(mesh, params))
    if kind == "prefill":
        step = make_prefill_step(cfg, mesh, shape)
        return (lambda: step(params, batch)), (params, batch)
    step = make_decode_step(cfg, mesh, shape)
    cache = _fake(cache_specs(cfg, shape))
    cache = distribute(cache, mesh, cache_shardings(
        mesh, cfg, cache, batch_size=SHAPES[shape]["batch"]))
    return ((lambda: step(params, batch["tokens"], cache)),
            (params, batch["tokens"], cache))


def _local_bytes(tree, skip=()) -> int:
    """Bytes of the distinct local storages of a tree's tensors, but
    those of ``skip``'s."""
    def ids(t):
        return {id(lt.untyped_storage()): lt.untyped_storage().nbytes()
                for x in _tensors(t) for lt in _locals(x)}

    seen = ids(skip)
    return sum(n for k, n in ids(tree).items() if k not in seen)


def ops_path(out_dir: str, arch: str, shape: str, multi_pod: bool) -> str:
    """Where ``--save-hlo`` writes a cell's op listing."""
    return os.path.join(out_dir,
                        f"{arch}.{shape}.{mesh_name(multi_pod)}.ops.gz")


def run_cell(arch: str, shape: str, *, multi_pod: bool,
             save_ops: str | None = None) -> dict:
    """One cell (the process must already be in a group of 256 or 512
    ranks): its record, as the JSON file holds it. ``save_ops`` (a
    directory) also writes the cell's op listing there (``ops_path``)."""
    cell = {"arch": arch, "shape": shape, "mesh": mesh_name(multi_pod)}
    cfg = get_config(arch)
    skip = shape_skip_reason(cfg, shape)
    if skip:
        cell.update(status="skipped", reason=skip)
        return cell
    t0 = time.time()
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    run, held, cfg, mesh = lower_cell(arch, shape, multi_pod=multi_pod,
                                      fake_mode=fake_mode)
    with fake_mode:
        with accounting(held, record=save_ops is not None) as acc:
            out = run()
        out_bytes = _local_bytes(out, skip=held)
    t_lower = time.time() - t0
    stats = acc.stats()
    n_dev = mesh.size()
    info = SHAPES[shape]
    mf = model_flops(cfg, info["kind"], info["batch"], info["seq"])
    rl = Roofline(flops=stats["flops"], hbm_bytes=stats["hbm_bytes"],
                  collective_bytes=stats["collective_bytes"],
                  model_flops_per_device=mf / n_dev,
                  flops_f32=stats["flops_f32"])
    total, active = model_params_active(cfg)
    cell.update(
        status="ok", t_lower_s=round(t_lower, 1), n_devices=n_dev,
        params_total=total, params_active=active,
        memory=dict(argument_bytes=stats["held_bytes"],
                    output_bytes=out_bytes,
                    peak_estimate=stats["peak_bytes"]),
        hlo={k: stats[k] for k in ("flops", "flops_f32", "hbm_bytes",
                                   "collective_bytes", "per_collective",
                                   "n_ops")},
        roofline=rl.as_dict())
    if save_ops is not None:
        os.makedirs(save_ops, exist_ok=True)
        with gzip.open(ops_path(save_ops, arch, shape, multi_pod), "wt") as f:
            for line in op_lines(acc.ops):
                f.write(line + "\n")
    return cell


def train_step_counts(cfg, batch: int, seq: int) -> tuple:
    """One device's train step (``make_train_step(cfg)``, no mesh) on a
    fake ``batch`` x ``seq`` batch of tokens, counted: ``(stats,
    Roofline)``. No group is needed; the count is the CUDA step's (the
    op sequence takes no device branch: ``launch.mesh``'s docstring)."""
    step, opt = make_train_step(cfg)
    with FakeTensorMode():
        params = _fake(models.init_params(cfg, torch.Generator(),
                                          torch.device("meta")))
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        tokens = torch.zeros((batch, seq), dtype=torch.int32)
        b = {"tokens": tokens, "labels": tokens.clone()}
        with accounting(state, b) as acc:
            step(state, b)
    st = acc.stats()
    return st, Roofline(flops=st["flops"], hbm_bytes=st["hbm_bytes"],
                        collective_bytes=st["collective_bytes"],
                        flops_f32=st["flops_f32"],
                        model_flops_per_device=model_flops(
                            cfg, "train", batch, seq))


def _write(cell: dict, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{cell['arch']}.{cell['shape']}.{cell['mesh']}.json")
    with open(path, "w") as f:
        json.dump(cell, f, indent=1)
    return path


def summary(cell: dict) -> str:
    """A cell's result in two lines (what ``main`` prints)."""
    if cell["status"] != "ok":
        return f"{cell['status']}: {cell.get('reason')}"
    rl, h = cell["roofline"], cell["hlo"]
    return (f"devices={cell['n_devices']} fake run={cell['t_lower_s']}s "
            f"peak_mem/dev={cell['memory']['peak_estimate'] / 2**30:.2f}GiB "
            f"flops/dev={h['flops']:.4g} (f32 {h['flops_f32']:.4g}) "
            f"hbm/dev={h['hbm_bytes']:.4g}B coll/dev="
            f"{h['collective_bytes']:.4g}B ops={h['n_ops']}\n"
            f"  t_comp={rl['t_compute_s']:.4f}s t_mem={rl['t_memory_s']:.4f}s "
            f"t_coll={rl['t_collective_s']:.4f}s dominant={rl['dominant']} "
            f"frac={rl['roofline_fraction']:.2f}")


def _run_all(args) -> int:
    todo = []
    for arch in ARCHS:
        for shape in SHAPES:
            for mp in (False, True):
                path = os.path.join(
                    args.out, f"{arch}.{shape}.{mesh_name(mp)}.json")
                if args.skip_existing and os.path.exists(path):
                    continue
                todo.append((arch, shape, mp))

    def one(cell):
        arch, shape, mp = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", args.out]
        if mp:
            cmd.append("--multi-pod")
        if args.save_hlo:
            cmd.append("--save-hlo")
        t0 = time.time()
        r = subprocess.run(cmd, capture_output=True, text=True)
        print(f"[dryrun] {arch} x {shape} x {mesh_name(mp)}: rc "
              f"{r.returncode}\n{r.stdout.strip()}", flush=True)
        if r.returncode != 0:
            path = os.path.join(
                args.out, f"{arch}.{shape}.{mesh_name(mp)}.json")
            if not (os.path.exists(path) and os.path.getmtime(path) >= t0):
                # the cell wrote no error record of its own: it died
                _write({"arch": arch, "shape": shape, "mesh": mesh_name(mp),
                        "status": "error",
                        "reason": f"subprocess rc={r.returncode}",
                        "stderr": r.stderr[-4000:]}, args.out)
            return cell
        return None

    t0 = time.time()
    with ThreadPoolExecutor(max(1, args.jobs)) as ex:
        failures = [c for c in ex.map(one, todo) if c is not None]
    status, secs = {}, []
    for arch, shape, mp in todo:
        path = os.path.join(args.out, f"{arch}.{shape}.{mesh_name(mp)}.json")
        with open(path) as f:
            cell = json.load(f)
        status[cell["status"]] = status.get(cell["status"], 0) + 1
        secs.append(cell.get("t_lower_s", 0.0))
    print(f"[dryrun] {len(todo)} cells: {status}; fake runs "
          f"{sum(secs):.1f} s in all, the longest {max(secs, default=0)} s; "
          f"{time.time() - t0:.1f} s on the wall at {args.jobs} at a time")
    print(f"[dryrun] done; {len(failures)} failures: "
          f"{[(a, s, mesh_name(m)) for a, s, m in failures]}")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="one arch id (or --all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every cell (each in a subprocess) incl. both "
                         "meshes")
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --all: cells run at once")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--save-hlo", action="store_true",
                    help="also write the cell's op listing (the port has "
                         "no HLO) to <arch>.<shape>.<mesh>.ops.gz")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if args.all:
        return _run_all(args)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    # DTensor warns of every two-step all-reduce it plans
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    join_fake(512 if args.multi_pod else 256)
    try:
        cell = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                        save_ops=args.out if args.save_hlo else None)
    except Exception as e:
        cell = {"arch": args.arch, "shape": args.shape,
                "mesh": mesh_name(args.multi_pod), "status": "error",
                "reason": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:]}
        path = _write(cell, args.out)
        print(f"[dryrun] ERROR -> {path}\n{cell['reason']}")
        return 1
    path = _write(cell, args.out)
    tag = "OK" if cell["status"] == "ok" else cell["status"]
    print(f"[dryrun] {tag} {path}\n  {summary(cell)}")
    if args.save_hlo and cell["status"] == "ok":
        print(f"[dryrun] op listing -> "
              f"{ops_path(args.out, args.arch, args.shape, args.multi_pod)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
