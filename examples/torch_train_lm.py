"""End-to-end training driver on the PyTorch port: a ~100M-parameter LM
through the whole stack: the sharded step on a device mesh, the
synthetic pipeline, and the checkpointing Trainer with crash recovery.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --fail-at 25
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu \\
        --layers 2 --d-model 64 --vocab 512 --steps 8

Defaults to 40 steps of 8 x 128 tokens. The mesh is ``--data-par`` x
``--model-par`` (1 x 1 by default: a one-rank group in this process); a
larger one spawns a rank per mesh device (``launch.mesh.spawn``), or
takes its ranks from ``torchrun``. Checkpoints go to ``--ckpt-dir``
every ``--ckpt-every`` steps, asynchronously, and a rerun resumes from
them; ``--fail-at`` injects crashes the Trainer recovers from.
``--layers``, ``--d-model`` and ``--vocab`` shrink the model (heads and
FFN keep their ratios). Returns (``main``) the parameter count, the
losses, the step times and the restarts.
"""
import argparse
import os
import sys
import tempfile

import torch
import torch.distributed as dist

from repro_torch import models
from repro_torch.configs import LayerSpec, ModelConfig
from repro_torch.data import SyntheticLM
from repro_torch.data.pipeline import batch_shards
from repro_torch.device import where
from repro_torch.launch.mesh import (join, make_host_mesh, rank_device,
                                     regroup, spawn)
from repro_torch.runtime.ftolerance import Trainer
from repro_torch.runtime.sharding import distribute
from repro_torch.train.step import (distribute_batch, make_train_step,
                                    train_state_specs)


def config_100m(n_layers: int = 8, d_model: int = 512,
                vocab: int = 32000) -> ModelConfig:
    """The reference example's ~100M LM (8 layers, d 512, 8 query and 4
    kv heads, vocab 32,000, f32), narrower or shallower if asked."""
    return ModelConfig(
        name="lm-100m", family="lm", n_layers=n_layers, d_model=d_model,
        n_heads=8, n_kv_heads=4, head_dim=d_model // 8, d_ff=4 * d_model,
        vocab=vocab, group=(LayerSpec(),), qk_norm=True,
        param_dtype="float32", compute_dtype="float32", scan_chunk=32,
    ).validate()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject crashes at these steps (recovery demo)")
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Train on the joined group's mesh; rank 0 prints. Returns plain
    numbers (a spawned rank pickles them back)."""
    cfg = config_100m(args.layers, args.d_model, args.vocab)
    dev = rank_device(args.device)
    mesh = make_host_mesh(args.data_par, args.model_par,
                          device_type=dev.type)
    rank = dist.get_rank()
    step_fn, opt = make_train_step(cfg, mesh, lr=3e-4)
    shard = train_state_specs(cfg, mesh, opt)[1]
    params0 = models.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = models.param_count(params0)
    card = where(dev)
    if rank == 0:
        print(f"model: {cfg.name}  params={n_params / 1e6:.1f}M  "
              f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}  on "
              f"{card}", flush=True)

    def init_state():
        state = {"params": params0, "opt": opt.init(params0),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        return distribute(state, mesh, shard)

    specs = {"tokens": ((args.batch, args.seq), torch.int32),
             "labels": ((args.batch, args.seq), torch.int32)}
    pipe = SyntheticLM(cfg, args.batch, args.seq, seed=0)
    shards = batch_shards(mesh, args.batch)
    trainer = Trainer(
        step_fn=step_fn, init_state_fn=init_state,
        next_batch_fn=lambda s: distribute_batch(
            pipe.next_batch(s, specs, dev, shards), mesh),
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        fail_at=set(args.fail_at), async_ckpt=True,
        restore_shardings=shard)
    trainer.run(args.steps)

    losses = [m["loss"] for m in trainer.metrics_log]
    times = sorted(trainer.step_times)
    median = times[len(times) // 2] if times else float("nan")
    if rank == 0:
        print(f"steps={len(trainer.metrics_log)} "
              f"restarts={trainer.restarts} "
              f"stragglers={len(trainer.monitor.flagged)}")
        print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f} "
              f"(improved={losses[-1] < losses[0]}); median step "
              f"{median * 1e3:.1f} ms on {card}")
    return {"device": dev.type, "card": card, "n_params": n_params,
            "mesh": [args.data_par, args.model_par], "losses": losses,
            "step_times": list(trainer.step_times), "median_step_s": median,
            "restarts": trainer.restarts,
            "stragglers": len(trainer.monitor.flagged),
            "steps_run": [m["step"] for m in trainer.metrics_log]}


def main(argv=None) -> dict:
    args = parse_args(argv)
    n = args.data_par * args.model_par
    if dist.is_initialized():              # the caller's group
        return run(args)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # torchrun
        join(args.device)
        try:
            return run(args)
        finally:
            dist.destroy_process_group()
    if n > 1:
        return spawn(run, n, args, device=args.device)[0]
    # 1 x 1: a one-rank group in this process
    with tempfile.TemporaryDirectory() as d:
        regroup(os.path.join(d, "store"), 0, 1, args.device)
        try:
            return run(args)
        finally:
            dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
