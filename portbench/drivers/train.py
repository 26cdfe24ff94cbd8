"""The training driver: the program's one-device training step
(``train/step.py:make_train_step``: CE + z-loss by autograd with remat as
configured, clipping, AdamW with f32 state) on the configuration's model.

Set-up builds one object, the step with its params and optimizer state,
from the seed, and drives it through its first ``check_steps`` steps, on
rows that all differ and through the window's own call and feed. It
takes the program's readings there: each step's loss, the first
gradient as the optimizer got it (AdamW's first moment after one step
over ``1 - b1``), and the params' change after the last of them. The
window then continues the same object for ``--seconds``; every step ends
in the read-back of its loss. After the window the reference follows the
same first steps from the same seed (``reference/train.py``).
"""
from __future__ import annotations

import gc
import time

import torch

from portbench.reference import train as ref
from portbench.yardstick import traffic
from portbench.yardstick.profiling import DeviceTrace
from portbench.yardstick.weights import make_weights

B1 = 0.9        # AdamW's first-moment decay (the program's default)


def _batch(mix, seed, step, vocab, dev):
    rows = torch.from_numpy(traffic.train_rows(mix, seed, step, vocab))
    return {"tokens": rows[:, :-1].to(dev, torch.int32),
            "labels": rows[:, 1:].to(dev, torch.int32)}


def run(job: dict) -> dict:
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.train.step import make_train_step

    from .serve import _check_dims

    conf, mix, cpu = job["config"], job["mix"], job["cpu"]
    dims = conf["cpu_dry_run"]["dims"] if cpu else conf["dims"]
    cfg = (get_reduced_config if cpu else get_config)(conf["program_arch"])
    _check_dims(cfg, dims)
    dev = torch.device("cpu" if cpu else "cuda")
    dtype = getattr(torch, dims["dtype"])
    seed, seconds, V = job["seed"], job["seconds"], dims["vocab"]
    lr, n_check = mix["lr"], mix["check_steps"]
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)

    params = make_weights(dims, seed, dev, dtype)
    start = ref.leaves(params)
    start = {p: t.detach().clone() for p, t in start}
    step_fn, opt = make_train_step(cfg, lr=lr)
    state = {"params": params, "opt": opt.init(params), "step": 0}
    del params
    losses, grad = [], None
    for i in range(n_check):
        state, m = step_fn(state, _batch(mix, seed, i, V, dev))
        losses.append(float(m["loss"]))
        if i == 0:
            grad = {k: v / (1 - B1) for k, v in ref.norms(
                state["opt"]["m"]).items()}
    change = ref.norms(ref.as_tree({
        p: t.detach() - start[p] for p, t in ref.leaves(state["params"])}))
    del start
    prog = {"losses": losses, "grad": grad, "change": change}
    sync()

    dt = DeviceTrace() if job["trace"] and dev.type == "cuda" else None
    if dt is not None:
        dt.arm()
    prof = mix["profile"]     # whole steps: marked between two of them
    steps, i = 0, n_check
    spans = []                      # the host's step calls and read-backs
    w0 = time.perf_counter()
    setup_s = w0 - job["t_proc"]
    while True:
        t = time.perf_counter()
        if dt is not None and (dt.t0 is None and t - w0 >= prof["from_s"]
                               or dt.active
                               and t - dt.t0 >= prof["seconds"]):
            dt.mark()
        t = time.perf_counter()
        state, m = step_fn(state, _batch(mix, seed, i, V, dev))
        t_call = time.perf_counter()
        float(m["loss"])
        t_end = time.perf_counter()
        if dt is not None:
            spans += [{"name": "step call", "track": "train", "start": t,
                       "end": t_call},
                      {"name": "loss read-back", "track": "train",
                       "start": t_call, "end": t_end}]
        steps, i = steps + 1, i + 1
        if t_end - w0 >= seconds:
            break
    w1 = time.perf_counter()
    if dt is not None:
        dt.finish()
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    device = (dt.reduce(spans) if dt is not None and dt.t0 is not None
              else None)
    del state, step_fn, opt, m
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    batches = [(b["tokens"], b["labels"]) for b in
               (_batch(mix, seed, j, V, dev) for j in range(n_check))]
    base = ref.follow(make_weights(dims, seed, dev, dtype), dims, batches,
                      lr=lr)
    check = ref.compare(prog, base)
    if job.get("control"):
        low = ref.follow(make_weights(dims, seed, dev, dtype), dims,
                         batches, lr=lr, lowp=job["control"])
        check.update({f"control_{k}": v for k, v in
                      ref.compare(low, base).items() if k != "left_out"})
    left_out = check.pop("left_out")
    tokens = steps * mix["batch"] * mix["seq"]
    notes = {"steps": steps, "window_s": w1 - w0, "left_out": left_out,
             "losses": prog["losses"], "reference_losses": base["losses"]}
    return {"notes": notes, "records": [], "window": (w0, w1),
            "setup_s": setup_s,
            "steps": steps, "tokens": tokens, "batch": mix["batch"],
            "seq": mix["seq"], "device_trace": device,
            "memory_peak": int(memory_peak), "dims": dims,
            "attempted": steps, "failed": 0, "check": check}
