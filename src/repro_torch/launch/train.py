"""Training launcher (port of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch qwen3_0_6b --steps 50
    python -m repro_torch.launch.train --reduced --device cpu --steps 20
    python -m repro_torch.launch.train --reduced --device cpu \\
        --data-par 2 --model-par 2
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --reduced \\
        --device cpu --data-par 2 --model-par 2

Trains ``--arch`` from seeded random weights on the synthetic token
stream (``data.SyntheticLM``) through ``runtime.ftolerance.Trainer``:
asynchronous checkpoints every ``--ckpt-every`` steps under
``--ckpt-dir``, from which a rerun resumes, on any mesh (a checkpoint
holds full tensors). It runs on the card (``--device cuda``, the
default, which fails without a GPU).

The mesh is ``--data-par`` x ``--model-par``. At 1 x 1 the step is the
one-device step, with no process group. A larger mesh runs one rank per
mesh device: under ``torchrun`` the ranks come from its environment;
otherwise the launcher spawns data x model ranks joined through a file
store (``launch.mesh.spawn``). ``--host-devices`` (the reference's forced
host device count) is accepted for the reference's command lines only:
it must equal data x model and adds nothing. Rank r computes on
``cuda:(LOCAL_RANK % device_count)`` or the CPU (``--device cpu``); the
backend is NCCL with a GPU per rank and gloo otherwise. Rank 0 prints.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--host-devices", type=int, default=None,
                    help="accepted for the reference's command lines: "
                         "must equal data x model (the ranks spawned)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    args = ap.parse_args(argv)
    n = args.data_par * args.model_par
    if args.data_par < 1 or args.model_par < 1:
        raise SystemExit(f"[train] refused: --data-par {args.data_par} "
                         f"--model-par {args.model_par}: sizes must be >= 1")
    if args.host_devices is not None and args.host_devices != n:
        raise SystemExit(
            f"[train] refused: --host-devices {args.host_devices} != "
            f"--data-par x --model-par = {n}: the mesh needs one rank a "
            f"device")
    return args


def _under_torchrun() -> bool:
    return "TORCHELASTIC_RUN_ID" in os.environ or (
        "RANK" in os.environ and "WORLD_SIZE" in os.environ)


def run(args) -> dict:
    """Train and print the reference's two lines (rank 0). On a mesh the
    caller has joined the process group (``main`` does). Returns {"cfg",
    "trainer", "state", "n_params", "mesh"}."""
    import torch.distributed as dist

    from repro_torch import models
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.data import SyntheticLM
    from repro_torch.data.pipeline import batch_shards
    from repro_torch.runtime.ftolerance import Trainer
    from repro_torch.runtime.sharding import distribute
    from repro_torch.train.step import (distribute_batch, make_train_step,
                                        train_state_specs)
    from repro_torch.tree import leaves

    cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    on_mesh = dist.is_initialized()
    if on_mesh:
        from repro_torch.launch.mesh import make_host_mesh, rank_device

        dev = rank_device(args.device)
        mesh = make_host_mesh(args.data_par, args.model_par,
                              device_type=dev.type)
        rank = dist.get_rank()
    else:
        from repro_torch.device import resolve_device

        dev, mesh, rank = resolve_device(args.device), None, 0
    step_fn, opt = make_train_step(cfg, mesh, lr=args.lr)
    shard = train_state_specs(cfg, mesh, opt)[1] if mesh is not None \
        else None

    # full weights from the seeded generator, the same on every rank
    params0 = models.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)

    def init_state():    # the update is functional: params0 stays as is
        state = {"params": params0, "opt": opt.init(params0),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        return state if mesh is None else distribute(state, mesh, shard)

    n_params = sum(t.numel() for t in leaves(params0))
    mesh_shape = {"data": args.data_par, "model": args.model_par}
    if rank == 0:
        print(f"[train] {cfg.name}: {n_params / 1e6:.1f}M params, "
              f"mesh={mesh_shape}, steps={args.steps}", flush=True)
    specs = {"tokens": ((args.batch, args.seq), torch.int32),
             "labels": ((args.batch, args.seq), torch.int32)}
    pipe = SyntheticLM(cfg, args.batch, args.seq)
    shards = batch_shards(mesh, args.batch)

    def next_batch(s):
        b = pipe.next_batch(s, specs, dev, shards)
        return b if mesh is None else distribute_batch(b, mesh)

    trainer = Trainer(step_fn=step_fn, init_state_fn=init_state,
                      next_batch_fn=next_batch, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, async_ckpt=True,
                      restore_shardings=shard)
    state = trainer.run(args.steps)
    log = trainer.metrics_log
    if rank == 0:
        print(f"[train] done: loss {log[0]['loss']:.4f} -> "
              f"{log[-1]['loss']:.4f}; restarts={trainer.restarts} "
              f"stragglers={len(trainer.monitor.flagged)}", flush=True)
    return {"cfg": cfg, "trainer": trainer, "state": state,
            "n_params": n_params, "mesh": mesh}


def summary(r: dict) -> dict:
    """What a rank hands back from ``run``: plain numbers only."""
    t = r["trainer"]
    dev = next(iter(r["state"]["params"].values()))
    dev = dev.to_local().device if hasattr(dev, "to_local") else dev.device
    return {"metrics_log": t.metrics_log, "step_times": t.step_times,
            "ckpt_log": t.ckpt_log, "restarts": t.restarts,
            "step": int(r["state"]["step"]), "n_params": r["n_params"],
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None)}


def rank_main(args) -> dict:
    """One spawned rank's body: ``run`` then its ``summary``."""
    return summary(run(args))


def main(argv=None) -> dict:
    """1 x 1: ``run`` in this process (its full result). A mesh: under
    ``torchrun`` join and run this rank (its full result); otherwise
    spawn the ranks and return rank 0's ``summary`` with every rank's
    under ``"ranks"``."""
    args = parse_args(argv)
    n = args.data_par * args.model_par
    if _under_torchrun():
        from repro_torch.launch.mesh import join

        join(args.device)
        import torch.distributed as dist

        try:
            return run(args)
        finally:
            dist.destroy_process_group()
    if n == 1:
        return run(args)
    from repro_torch.launch.mesh import spawn

    ranks = spawn(rank_main, n, args, device=args.device)
    return dict(ranks[0], ranks=ranks)


if __name__ == "__main__":
    main()
