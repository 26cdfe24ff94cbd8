"""``mfu``: the model FLOPs of the work the window completed over the
window's wall time, as a share of the H100's 989 TFLOP/s bf16 peak, %.

Serving: every served request's prompt, its decode steps and the head at
each served token (``yardstick/flops.py:serve_request_flops``). Training:
``train_step_flops`` of each step of the window."""
from portbench.yardstick.flops import (PEAK_BF16, serve_request_flops,
                                       train_step_flops)


def read(out: dict):
    w0, w1 = out["window"]
    dims = out["dims"]
    if "steps" in out:
        flops = out["steps"] * train_step_flops(dims, out["batch"],
                                                out["seq"])
    else:
        flops = sum(serve_request_flops(dims, len(r["prompt"]),
                                        len(r["served"]))
                    for r in out.get("records", ()))
    return None if flops <= 0 else 100.0 * flops / (w1 - w0) / PEAK_BF16
