"""The metric arithmetic: end-to-end metrics over the whole window and
every request, the per-layer readers, and the operation and byte counts
against hand counts at small shapes."""
import importlib.util
from pathlib import Path

import pytest

from portbench.yardstick import endtoend, flops, profiling

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _rec(arrival, first, gaps, served=None, prompt=4):
    served = served if served is not None else [1] * (len(gaps) + 1)
    return {"id": int(arrival * 100), "arrival": arrival, "first": first,
            "gaps": list(gaps), "served": served, "prompt": [0] * prompt,
            "max_new": len(served), "queue_wait": 0.0,
            "token_times": []}


def _out(records, w0=0.0, w1=10.0):
    return {"records": records, "window": (w0, w1), "setup_s": 1.0}


def _steady():
    return [_rec(float(i), i + 0.1, [0.05] * 9) for i in range(40)]


def test_a_stall_moves_the_rate_and_the_tail():
    base = _out(_steady(), 0.0, 45.0)
    stalled = _steady()
    for r in stalled[::7]:                 # one gap in seven requests
        r["gaps"][3] = 2.0
    hit = _out(stalled, 0.0, 47.0)          # the stall lengthens the window
    assert endtoend.output_tokens_per_s(hit) \
        < endtoend.output_tokens_per_s(base)
    # 6 of 360 gaps stalled: under the p95 rank; 20 stalled move it
    for r in stalled[::2]:
        r["gaps"][5] = 2.0
    assert endtoend.itl_p95_ms(hit) > endtoend.itl_p95_ms(base)


def test_a_missing_request_counts_to_the_end_of_the_window():
    recs = _steady()
    for r in recs[-6:]:            # more than a tenth never started
        r["first"], r["gaps"], r["served"] = None, [], []
    out = _out(recs, 0.0, 60.0)
    # the p90 lands among them: each waited from its arrival to the end
    ttft = _reader("ttft_p90_ms")
    assert ttft(out) > 1e3 * (60.0 - 39.0)
    assert ttft(out) > ttft(_out(_steady(), 0.0, 60.0))


def test_setup_and_train_rate():
    out = {"window": (2.0, 12.0), "tokens": 40960, "setup_s": 3.5}
    assert endtoend.train_tokens_per_s(out) == pytest.approx(4096.0)
    assert endtoend.setup_s(out) == 3.5


DIMS = {"n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
        "head_dim": 2, "d_ff": 16, "vocab": 10}


def test_model_flops_by_hand():
    # projections: q 8x8, k 8x4, v 8x4, o 8x8, three 8x16 -> 576 a layer
    assert flops.projection_params(DIMS) == 2 * 576
    # queries at positions 0..2 read 1+2+3 keys; 4 H Dh L = 64 a key
    assert flops.attention_flops(DIMS, 0, 3) == 64 * 6
    # a prompt of 3 and 2 served tokens: 4 tokens fed, 2 logits rows
    want = 2 * 1152 * 4 + 64 * 10 + 2 * 8 * 10 * 2
    assert flops.serve_request_flops(DIMS, 3, 2) == want
    # one train step of 1 x 3: 6 a param a token, the head at 3 rows
    assert flops.train_step_flops(DIMS, 1, 3) == \
        6 * (1152 * 3 + 80 * 3) + 3 * 64 * 6


def test_kernel_counts_by_hand():
    # one row: every launch is byte-bound (2 K N FLOPs against K N bytes)
    shapes = [(8, 8), (8, 4), (8, 4), (8, 8), (8, 16), (8, 16), (16, 8)]
    n = 2 * sum(K * N + 64 + 2 * (K + N) for K, N in shapes)
    assert flops.qmm_bound(DIMS, 1) == pytest.approx(
        n / flops.HBM_BYTES_PER_S)
    # a decode row at 21 keys with pages of 8: 2 frozen pages + 5 hot rows
    f, n = flops.pa_rows(DIMS, 8, 21, 1)
    page = 2 * (8 * 2 * 2 // 2 + 64)
    assert n == 2 * page + 5 * 2 * 2 * 2 * 2 + 2 * 4 * 2 * 2
    assert f == 4 * 4 * 2 * 21
    assert flops.pa_bound(f, n, 3) == 3 * n / flops.HBM_BYTES_PER_S


def test_union_and_gaps_of_the_device_timeline():
    dev = [(10, 20), (15, 30), (40, 50)]
    busy, gaps = profiling._union_and_gaps(list(dev), 0, 60)
    assert busy == 30 and gaps == [(0, 10), (30, 40), (50, 60)]
    # host spans in seconds on the device's clock: the innermost names
    host = [(28e-9, 45e-9, "decode/w0 sync"), (0.0, 60e-9, "decode_step")]
    idle = profiling._label_gaps(gaps, host)
    assert idle["decode/w0 sync"] == pytest.approx(10e-9)
    assert idle["decode_step"] == pytest.approx(20e-9)
    assert profiling._label_gaps([(0, 5)], [])["host outside the spans"] \
        == pytest.approx(5e-9)


def test_readers_leave_out_what_they_cannot_read():
    for name in ("device_idle", "pa_roofline", "qmm_roofline",
                 "prefill_chunk_ms", "decode_dispatch_ms",
                 "freeze_flush_ms", "ttft_p90_ms"):
        assert _reader(name)({"records": [], "spans": [],
                              "device_trace": None}) is None


def test_roofline_reader_against_a_hand_count():
    dims = dict(DIMS)
    out = {"dims": dims, "mix": {"engine": {"block_size": 8}},
           "records": [{"id": 1, "prompt": [0] * 20,
                        "token_times": [0.5, 1.0, 2.0, 9.0]}],
           "spans": [{"name": "decode_step", "start": 0.9, "end": 1.0,
                      "args": {"active": 1}}],
           "device_trace": {"span": (0.8, 3.0),
                            "kernel_s": {"paged_attention_kernel<1>": 1e-6,
                                         "quant_matmul_kernel<2>": 2e-6}}}
    pa = sum(flops.pa_bound(*flops.pa_rows(dims, 8, 20 + k, 1), 2)
             for k in (1, 2))
    assert _reader("pa_roofline")(out) == pytest.approx(100 * pa / 1e-6)
    qmm = flops.qmm_bound(dims, 1)
    assert _reader("qmm_roofline")(out) == pytest.approx(100 * qmm / 2e-6)
    out["device_trace"].update(busy_s=0.5, window_s=2.0)
    assert _reader("device_idle")(out) == pytest.approx(75.0)


class _Ev:
    def __init__(self, name, start, dur, cuda=True):
        import torch

        self._n, self._s, self._d = name, start, dur
        self._t = (torch.autograd.DeviceType.CUDA if cuda
                   else torch.autograd.DeviceType.CPU)

    def name(self):
        return self._n

    def device_type(self):
        return self._t

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_device_trace_reduces_between_its_markers():
    """The span is the device time between the two marker kernels; work
    outside it and the host's events are left out; a gap is named by the
    host span covering it, moved onto the device's clock."""
    from types import SimpleNamespace

    evs = [_Ev("k_before", 0, 900), _Ev("at::spin_kernel", 1000, 10),
           _Ev("k1", 1100, 400), _Ev("cudaLaunchKernel", 1150, 5, False),
           _Ev("k2", 1400, 200), _Ev("k3", 2000, 300),
           _Ev("at::spin_kernel", 2500, 10), _Ev("k_after", 2600, 100)]
    dt = profiling.DeviceTrace()
    dt.prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))
    dt.t0, dt.t1 = 5.0, 5.0 + 1.5e-6     # host seconds at the markers
    spans = [{"name": "sync", "track": "decode/w0",
              "start": 5.0 + 700e-9, "end": 5.0 + 900e-9}]
    r = dt.reduce(spans)
    assert r["window_s"] == pytest.approx(1490e-9)
    assert r["busy_s"] == pytest.approx((500 + 300) * 1e-9)
    assert set(r["kernel_s"]) == {"k1", "k2", "k3"}
    idle = dict(r["idle_gaps"])
    assert idle["decode/w0 sync"] == pytest.approx(400e-9)   # 1600-2000
    assert idle["host outside the spans"] == pytest.approx(290e-9)
