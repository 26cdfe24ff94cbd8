"""``pa_roofline``: kernel 1 (the paged-attention kernel,
``kernels/csrc/paged_attention.cu``) against the least time of the work
the traffic gave it in the profiled span, %.

Its device time is the profiler's time of the kernels whose name holds
``paged_attention``. The work is counted from the requests' lengths
(``yardstick/flops.py:pa_rows``): each decode step whose tokens were
emitted in the span reads every live sequence's context once a layer, and
each prefill chunk that ended in the span (the program's
``prefill_chunk`` spans give its offset and size) reads its context once
a layer. Every launch is bounded by the larger of its FLOPs at the bf16
peak and its bytes at the HBM rate; decode launches are byte-bound."""
from collections import defaultdict

from portbench.yardstick.flops import pa_bound, pa_rows

KERNEL = "paged_attention"


def read(out: dict):
    dt = out.get("device_trace")
    if not dt:
        return None
    t_kernel = sum(s for n, s in dt["kernel_s"].items() if KERNEL in n)
    if t_kernel <= 0:
        return None
    dims, mix = out["dims"], out["mix"]
    block, L = mix["engine"]["block_size"], dims["n_layers"]
    a, b = dt["span"]
    steps = defaultdict(lambda: [0.0, 0.0])
    plen = {}
    for r in out["records"]:
        P = len(r["prompt"])
        plen[r["id"]] = P
        for k, t in enumerate(r["token_times"][1:], start=1):
            if a <= t <= b:
                f, n = pa_rows(dims, block, P + k, 1)
                steps[t][0] += f
                steps[t][1] += n
    bound = sum(pa_bound(f, n, L) for f, n in steps.values())
    for s in out.get("spans", ()):
        if s["name"] != "prefill_chunk" or not a <= s["end"] <= b:
            continue
        P = plen.get(s["args"]["rid"])
        if P is None:
            continue
        off = s["args"]["off"]
        rows = min(s["args"]["chunk"], P - off)
        if rows > 0:
            bound += pa_bound(*pa_rows(dims, block, off + rows, rows), L)
    return 100.0 * bound / t_kernel if bound > 0 else None
