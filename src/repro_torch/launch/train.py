"""Training launcher (port of ``repro/launch/train.py``) on one device.

    python -m repro_torch.launch.train --arch qwen3_0_6b --steps 50
    python -m repro_torch.launch.train --reduced --device cpu --steps 20

Trains ``--arch`` from seeded random weights on the synthetic token
stream (``data.SyntheticLM``) through ``runtime.ftolerance.Trainer``:
asynchronous checkpoints every ``--ckpt-every`` steps under
``--ckpt-dir``, from which a rerun resumes. It runs on the card
(``--device cuda``, the default, which fails without a GPU). The mesh is
1 x 1: ``--data-par``/``--model-par`` other than 1 are refused until the
sharding layer is ported (ROADMAP A4), and ``--host-devices`` (the
reference's forced host device count) is accepted and ignored.
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
                    help="the reference's forced host device count; "
                         "ignored (one device)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    args = ap.parse_args(argv)
    if (args.data_par, args.model_par) != (1, 1):
        raise SystemExit(
            f"[train] refused: --data-par {args.data_par} --model-par "
            f"{args.model_par}: a mesh larger than 1 x 1 needs the sharding "
            f"layer (runtime/sharding.py), not ported yet (ROADMAP A4)")
    return args


def run(args) -> dict:
    """Train and print the reference's two lines. Returns {"cfg",
    "trainer", "state", "n_params"}."""
    from repro_torch import models
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.data import SyntheticLM
    from repro_torch.device import resolve_device
    from repro_torch.runtime.ftolerance import Trainer
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves

    if args.host_devices is not None:
        print(f"[train] --host-devices {args.host_devices} ignored: the "
              f"port trains on one device")
    dev = resolve_device(args.device)
    cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    step_fn, opt = make_train_step(cfg, lr=args.lr)

    params0 = models.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)

    def init_state():    # the update is functional: params0 stays as is
        return {"params": params0, "opt": opt.init(params0),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    n_params = sum(t.numel() for t in leaves(params0))
    print(f"[train] {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"mesh={{'data': 1, 'model': 1}}, steps={args.steps}")
    specs = {"tokens": ((args.batch, args.seq), torch.int32),
             "labels": ((args.batch, args.seq), torch.int32)}
    pipe = SyntheticLM(cfg, args.batch, args.seq)
    trainer = Trainer(step_fn=step_fn, init_state_fn=init_state,
                      next_batch_fn=lambda s: pipe.next_batch(s, specs, dev),
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                      async_ckpt=True)
    state = trainer.run(args.steps)
    log = trainer.metrics_log
    print(f"[train] done: loss {log[0]['loss']:.4f} -> "
          f"{log[-1]['loss']:.4f}; restarts={trainer.restarts} "
          f"stragglers={len(trainer.monitor.flagged)}")
    return {"cfg": cfg, "trainer": trainer, "state": state,
            "n_params": n_params}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
