"""``qmm_roofline``: kernel 2 (the dequant matmul,
``kernels/csrc/quant_matmul.cu``) against the least time of the work the
traffic gave it in the profiled span, %.

Its device time is the profiler's time of the kernels whose name holds
``quant_matmul``. The work (``yardstick/flops.py:qmm_bound``): every model
call in the span, a decode step (the program's ``decode_step`` spans, at
its live rows) or a prefill chunk (``prefill_chunk`` spans, at its prompt
rows), reads each layer's uint8 codes and codebook once, x once and
writes the output once; each launch is bounded by the larger of its
FLOPs at the bf16 peak and its bytes at the HBM rate."""
from portbench.yardstick.flops import qmm_bound

KERNEL = "quant_matmul"


def read(out: dict):
    dt = out.get("device_trace")
    if not dt:
        return None
    t_kernel = sum(s for n, s in dt["kernel_s"].items() if KERNEL in n)
    if t_kernel <= 0:
        return None
    dims = out["dims"]
    a, b = dt["span"]
    plen = {r["id"]: len(r["prompt"]) for r in out["records"]}
    bound = 0.0
    for s in out.get("spans", ()):
        if not a <= s["end"] <= b:
            continue
        if s["name"] == "decode_step":
            rows = s["args"].get("active", 0)
        elif s["name"] == "prefill_chunk" and s["args"]["rid"] in plen:
            rows = min(s["args"]["chunk"],
                       plen[s["args"]["rid"]] - s["args"]["off"])
        else:
            continue
        if rows > 0:
            bound += qmm_bound(dims, rows)
    return 100.0 * bound / t_kernel if bound > 0 else None
