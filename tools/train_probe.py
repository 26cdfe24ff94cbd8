"""Where a train step's time goes on the card: ``train/step.py``'s step on
qwen3-0.6B at full width (bf16 weights, f32 AdamW state) and 8 x 1024
tokens, the shape of ``chip_smoke.py`` phase train (a). Two warm steps,
then one step under ``torch.profiler``: the step's host-timed wall time
(it ends in a sync), the device's busy time (union of kernel intervals)
and idle share, its kernel count, and the kernels taking the most device
time; then the same step's parts alone between syncs: the forward + the
loss + the backward, and the clip + optimizer update. One JSON line.
Needs one NVIDIA GPU.

    python3 tools/train_probe.py [--layers N] [--batch B] [--seq S]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (puts this checkout's src/ on the path)
import torch  # noqa: E402


def busy_us(prof) -> tuple[float, int, list]:
    """(device busy us, kernel count, top 8 (name, count, us))."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            a, b = e.time_range.start, e.time_range.end
            spans.append((a, b))
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + (b - a))
    spans.sort()
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return busy, len(spans), [(k[:80], n, round(t, 1))
                              for k, (n, t) in top]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_probe: no CUDA device visible", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import serve
    from repro_torch.train.step import lm_loss, make_train_step
    from repro_torch.tree import leaves, tree_map, unflatten

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen3_0_6b")
    if a.layers:
        cfg = serve.cut_depth(cfg, a.layers)
    params = models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    step, opt = make_train_step(cfg)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    del params
    pipe = SyntheticLM(cfg, a.batch, a.seq)
    batch = pipe.next_batch(0, pipe.batch_specs(), "cuda")
    for _ in range(2):
        state, m = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        wall = (time.perf_counter() - t0) * 1e6
    busy, n, top = busy_us(prof)

    def timed(fn) -> tuple:
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def fwd_bwd():
        p = tree_map(lambda t: t.detach().requires_grad_(), state["params"])
        return torch.autograd.grad(lm_loss(p, cfg, batch)[0], leaves(p))

    grads, fb_ms = timed(fwd_bwd)
    gt = unflatten(state["params"], [x.float() for x in grads])
    del grads
    _, opt_ms = timed(lambda: opt.update(gt, state["opt"], state["params"],
                                         lr=3e-4))
    print(chip_smoke.card_line())
    print(json.dumps({
        "cfg": cfg.name, "layers": cfg.n_layers, "tokens": a.batch * a.seq,
        "step_ms": round(wall / 1e3, 3), "device_busy_ms": round(busy / 1e3,
                                                                  3),
        "idle_share": round(1 - busy / wall, 4), "kernels": n,
        "fwd_loss_bwd_ms": round(fb_ms, 3), "optimizer_ms": round(opt_ms, 3),
        "top_kernels_us": top, "loss": float(m["loss"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
