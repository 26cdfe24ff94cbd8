"""The port's observability units (``repro_torch.obs``: the recording
``Tracer``, ``FakeClock``, the event helpers, ``MetricsExporter``,
``prometheus_text`` and the modeled roofline gauges), held to the
reference's ``repro.obs``. Mirrors the unit tests of ``tests/test_obs.py``.

Tolerances: none. The same calls on a reference ``Tracer(FakeClock())`` and
on the port's give equal ``traceEvents`` (the metadata differs only in the
process name); ``prometheus_text`` of one snapshot is equal in both
packages; the modeled HBM bytes equal the reference's on the same host
state, and only the roofline's time differs, by the memory rate (the
H100's 3.35e12 B/s here, the reference's v5e 819e9 there).
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.obs import FakeClock as JaxFakeClock
from repro.obs import MetricsExporter as JaxMetricsExporter
from repro.obs import Registry as JaxRegistry
from repro.obs import Tracer as JaxTracer
from repro.obs import prometheus_text as jax_prometheus_text
from repro.obs.export import \
    modeled_decode_hbm_bytes as jax_modeled_decode_hbm_bytes
from repro.obs.export import \
    modeled_prefill_hbm_bytes as jax_modeled_prefill_hbm_bytes
from repro.serving.metrics import MetricsCollector as JaxMetricsCollector
from repro_torch import device
from repro_torch.configs import get_config
from repro_torch.obs import (FakeClock, MetricsExporter, NULL_TRACER,
                             Registry, Tracer, count_events,
                             modeled_decode_hbm_bytes,
                             modeled_prefill_hbm_bytes, prometheus_text,
                             select_events, tracks_of)
from repro_torch.obs.stats import LogHistogram
from repro_torch.serving.kv_cache import page_bytes
from repro_torch.serving.metrics import MetricsCollector, percentile

torch.set_num_threads(1)


def _make_full_tracer(T=Tracer, C=FakeClock):
    tr = T(clock=C())
    with tr.span("decode/w0", "decode_step", step=1):
        pass
    t0 = tr.now()
    tr.complete("transfer", "extract", t0, bytes=1024, pages=2)
    tr.instant("router", "admit", rid=0)
    tr.counter("decode/w0", "cache", occupancy=0.5, frozen_pages=3)
    tr.async_begin("freeze/w0", "page_freeze", 7, page=7, slot=0)
    tr.async_instant("freeze/w0", "page_freeze", 7, state="dispatched")
    tr.async_end("freeze/w0", "page_freeze", 7, state="installed")
    return tr


def test_tracer_chrome_schema():
    tr = _make_full_tracer()
    d = tr.to_dict()
    json.dumps(d, allow_nan=False)          # strict JSON throughout
    assert d["displayTimeUnit"] == "ms"
    evs = d["traceEvents"]
    # one labeled lane per component: thread_name + sort metadata a track
    names = {e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert names == {"decode/w0", "transfer", "router", "freeze/w0"}
    assert any(e["ph"] == "M" and e["name"] == "process_name" for e in evs)
    for e in evs:
        assert {"ph", "name", "pid"} <= set(e)
        if e["ph"] == "X":
            assert "ts" in e and "dur" in e and e["dur"] >= 0
        elif e["ph"] == "i":
            assert e["s"] == "t"
        elif e["ph"] in ("b", "n", "e"):
            # async spans need (cat, id) so Perfetto can pair them
            assert isinstance(e["id"], str) and e["cat"] == "freeze/w0"
        elif e["ph"] == "C":
            assert set(e["args"]) == {"occupancy", "frozen_pages"}
    assert count_events(tr.events, track="freeze/w0", ph="b") == 1
    assert count_events(tr.events, track="freeze/w0", ph="e") == 1
    assert count_events(tr.events, name="decode_step", ph="X") == 1
    assert [e["args"]["state"] for e in select_events(
        tr.events, name="page_freeze", ph="n")] == ["dispatched"]
    assert tracks_of(tr) == {"decode/w0": 1, "transfer": 2, "router": 3,
                             "freeze/w0": 4}
    # identical event sequences on fake clocks serialize byte-identically
    a = json.dumps(tr.to_dict(), sort_keys=True, separators=(",", ":"))
    b = json.dumps(_make_full_tracer().to_dict(), sort_keys=True,
                   separators=(",", ":"))
    assert a == b


def test_tracer_events_equal_the_reference():
    """The same calls on both packages' tracers give the same events;
    the metadata differs only in the process name."""
    port, ref = _make_full_tracer(), _make_full_tracer(JaxTracer,
                                                        JaxFakeClock)
    assert port.events == ref.events
    pm, rm = (t.to_dict()["traceEvents"][:-len(t.events)]
              for t in (port, ref))
    assert pm[0]["args"]["name"] == "repro_torch.serving"
    assert rm[0]["args"]["name"] == "repro.serving"
    assert pm[1:] == rm[1:]
    assert {k: v for k, v in pm[0].items() if k != "args"} \
        == {k: v for k, v in rm[0].items() if k != "args"}


def test_tracer_write_is_deterministic_strict_json(tmp_path):
    paths = []
    for tag in "ab":
        tr = _make_full_tracer()
        tr.write(str(tmp_path / f"{tag}.json"))
        paths.append(tmp_path / f"{tag}.json")
    raw = [p.read_bytes() for p in paths]
    assert raw[0] == raw[1]
    assert json.loads(raw[0]) == json.loads(json.dumps(
        _make_full_tracer().to_dict()))
    ref = tmp_path / "ref.json"
    _make_full_tracer(JaxTracer, JaxFakeClock).write(str(ref))
    assert raw[0] == ref.read_bytes().replace(b'"repro.serving"',
                                              b'"repro_torch.serving"')


def test_null_tracer_is_inert(tmp_path):
    assert NULL_TRACER.enabled is False
    s1 = NULL_TRACER.span("decode/w0", "x", a=1)
    s2 = NULL_TRACER.span("router", "y")
    assert s1 is s2                       # one shared span: no allocation
    with s1:
        pass
    NULL_TRACER.complete("t", "n", NULL_TRACER.now())
    NULL_TRACER.instant("t", "n")
    NULL_TRACER.counter("t", "n", v=1)
    NULL_TRACER.async_begin("t", "n", 1)
    NULL_TRACER.async_instant("t", "n", 1)
    NULL_TRACER.async_end("t", "n", 1)
    assert NULL_TRACER.events == ()
    assert NULL_TRACER.to_dict()["traceEvents"] == []
    path = tmp_path / "never.json"
    NULL_TRACER.write(str(path))
    assert not path.exists()


def test_log_histogram_percentiles():
    h = LogHistogram()
    assert h.percentile(50) is None       # empty: None, never NaN
    vals = [i / 1000.0 for i in range(1, 101)]      # 1 ms .. 100 ms
    for v in vals:
        h.observe(v)
    assert h.n == 100
    assert h.vmin == vals[0] and h.vmax == vals[-1]
    assert abs(h.mean - np.mean(vals)) < 1e-12
    # interior percentiles answer within the bucket's relative error
    for p in (50, 90, 99):
        want = float(np.percentile(vals, p))
        assert abs(h.percentile(p) / want - 1) < 0.16, (p, h.percentile(p))
    assert h.percentile(0) >= h.vmin
    assert h.percentile(100) == h.vmax
    # out-of-range values land in under/overflow but keep exact min/max
    h.observe(1e-9)
    h.observe(1e9)
    assert h.underflow == 1 and h.overflow == 1
    assert h.percentile(100) == 1e9
    json.dumps(h.snapshot(), allow_nan=False)


def test_log_histogram_windowed_delta():
    h = LogHistogram()
    for _ in range(10):
        h.observe(0.01)
    prev = h.state()
    for _ in range(10):
        h.observe(1.0)
    d = h.delta(prev)
    assert d["n"] == 10
    # the window sees only the second batch; the all-time view both
    assert abs(h.percentile(50, **d) / 1.0 - 1) < 0.16
    assert h.percentile(10) < 0.02


def _fill(reg):
    reg.counter("requests").inc(3)
    reg.gauge("occupancy").set(0.25)
    reg.gauge("occupancy").set(0.75)
    for v in (0.01, 0.02, 0.03):
        reg.histogram("ttft_s").observe(v)
    return reg


def test_registry_and_prometheus_text():
    reg = _fill(Registry())
    assert "requests" in reg and "missing" not in reg
    snap = reg.snapshot()
    json.dumps(snap, allow_nan=False)
    txt = prometheus_text(snap)
    assert "repro_requests_total 3" in txt
    assert "repro_occupancy 0.75" in txt
    assert "repro_occupancy_mean 0.5" in txt
    assert 'repro_ttft_s{quantile="0.5"}' in txt
    assert "repro_ttft_s_count 3" in txt
    # bare scalars (MetricsCollector.snapshot running totals) render too
    assert "repro_completed 4" in prometheus_text({"completed": 4})


def test_prometheus_text_equals_the_reference():
    snap = _fill(Registry()).snapshot()
    assert snap == _fill(JaxRegistry()).snapshot()
    assert prometheus_text(snap) == jax_prometheus_text(snap)
    assert prometheus_text(snap, prefix="x") \
        == jax_prometheus_text(snap, prefix="x")
    mixed = {"completed": 4, "flag": True, "name": "n/a", **snap}
    assert prometheus_text(mixed) == jax_prometheus_text(mixed)


def _exporter_lines(Exp, Reg, Clock, path):
    reg = Reg()
    exp = Exp(path, interval_s=1.0, clock=Clock(tick=0.4), registry=reg)
    out = []
    reg.histogram("itl_s").observe(0.01)
    out.append(exp.maybe_emit())                 # first call always emits
    reg.histogram("itl_s").observe(0.02)
    out.append(exp.maybe_emit())                 # 0.4 s < interval
    out.append(exp.maybe_emit())                 # 0.8 s
    out.append(exp.maybe_emit())                 # 1.2 s elapsed
    exp.close()
    return out, exp.lines


def test_exporter_interval_and_windows(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    out, lines = _exporter_lines(MetricsExporter, Registry, FakeClock, path)
    assert out[0] is not None and out[1] is None and out[2] is None
    line = out[3]
    assert line is not None and line["seq"] == 1
    # the window covers only what landed since the previous emit
    assert line["window"]["itl_s"]["n"] == 1
    rows = [json.loads(ln) for ln in open(path)]
    assert [r["seq"] for r in rows] == [0, 1, 2]
    assert rows[0]["window"]["itl_s"]["n"] == 1
    assert "window" not in rows[2]               # nothing new at close
    _, ref = _exporter_lines(JaxMetricsExporter, JaxRegistry, JaxFakeClock,
                             None)
    assert lines == ref


def test_exporter_lines_are_strict_json_without_an_empty_window(tmp_path):
    """A histogram with no sample in the interval leaves no percentile:
    absent, never NaN, so every line loads as strict JSON."""
    path = str(tmp_path / "m.jsonl")
    mc = MetricsCollector()
    exp = MetricsExporter(path, interval_s=0.0, clock=FakeClock())
    mc.arrival(0, 0.0, prompt_len=4)
    exp.maybe_emit(mc)
    mc.first_token(0, 0.5)
    mc.token(0, 0.6)
    exp.maybe_emit(mc)
    exp.close(mc)
    rows = [json.loads(ln, parse_constant=lambda c: pytest.fail(c))
            for ln in open(path)]
    assert len(rows) == 3 and [r["seq"] for r in rows] == [0, 1, 2]
    assert "window" not in rows[0] and "window" not in rows[2]
    assert rows[1]["window"]["itl_s"]["n"] == 1


def test_summary_zero_token_guard():
    mc = MetricsCollector()
    mc.arrival(0, 0.0, prompt_len=4)
    mc.finish(0, 1.0)                     # finished without any token
    assert mc.summary() == {"completed": 0, "completed_zero_token": 1}
    mc.arrival(1, 0.0, prompt_len=4)
    mc.prefill_start(1, 0.1)
    mc.first_token(1, 0.2)
    mc.token(1, 0.3)
    mc.finish(1, 0.3)
    out = mc.summary()
    assert out["completed"] == 1 and out["completed_zero_token"] == 1
    json.dumps(out, allow_nan=False)


def test_percentile_empty_and_strict_json():
    assert percentile([], 50) is None
    mc = MetricsCollector()
    mc.arrival(0, 0.0, prompt_len=4)
    mc.first_token(0, 0.5)
    mc.finish(0, 0.5)                     # exactly one token: no tpot
    out = mc.summary()
    assert "tpot_p50_s" not in out and "tpot_p99_s" not in out
    assert json.loads(json.dumps(out, allow_nan=False))["completed"] == 1


def _populate(mc):
    for rid in range(2):
        t = rid * 0.1
        mc.arrival(rid, t, prompt_len=8)
        mc.prefill_start(rid, t + 0.05)
        mc.first_token(rid, t + 0.1)
        for j in range(1, 5):
            mc.token(rid, t + 0.1 + 0.02 * j)
        mc.finish(rid, t + 0.18)
        mc.spec_step(2, 1, rolled_back=rid == 0)
    mc.sample_cache(0.5, 1000.0, 7000.0)
    mc.sample_cache(0.25, 500.0, 3500.0)
    return mc


def test_summary_key_compat_and_streaming_bounds():
    """The collector emits the reference's summary key set for a fully
    populated run, from O(1)-memory aggregates."""
    mc = _populate(MetricsCollector())
    tr = mc.traces[0]
    assert tr.queue_wait + tr.prefill_compute == pytest.approx(tr.ttft)
    out = mc.summary()
    assert set(out) == set(_populate(JaxMetricsCollector()).summary())
    assert out["cache_compression_final"] == pytest.approx(7.0)
    assert not hasattr(mc, "occupancy") and not hasattr(mc, "cache_bytes")
    nbuckets = len(mc.stats["itl_s"].counts)
    for j in range(10_000):
        mc.token(0, 1.0 + j * 0.001)
    assert len(mc.stats["itl_s"].counts) == nbuckets
    snap = mc.snapshot()
    json.dumps(snap, allow_nan=False)
    assert snap["spec_steps"] == 2
    prometheus_text(snap)


def test_snapshot_equals_the_reference():
    port = _populate(MetricsCollector()).snapshot()
    ref = _populate(JaxMetricsCollector()).snapshot()
    assert port == ref
    assert prometheus_text(port) == jax_prometheus_text(ref)


# ------------------------------------------------------------- roofline


def _worker(attn_impl, pb, *, lens, table, frozen, active):
    return SimpleNamespace(
        sched=SimpleNamespace(active_slots=lambda: list(active)),
        block_size=16, _pb=pb, lens=np.asarray(lens, np.int32),
        table=np.asarray(table, np.int32), _frozen_pages=set(frozen),
        attn_impl=attn_impl)


def test_the_roofline_rate_is_the_h100s_and_defined_once():
    import chip_smoke as smoke
    from repro_torch.analysis import roofline
    from repro_torch.obs import export

    assert device.HBM_BYTES_PER_S == 3.35e12
    assert export.HBM_BYTES_PER_S is device.HBM_BYTES_PER_S
    # the peaks too: the roofline's defaults and chip_smoke.py's bounds
    # read device.py's objects
    assert (device.BF16_FLOPS, device.F32_FLOPS) == (989e12, 67e12)
    assert device.LINK_BYTES_PER_S == 450e9
    r = roofline.Roofline(flops=0.0, hbm_bytes=0.0, collective_bytes=0.0)
    assert r.hbm_bw is device.HBM_BYTES_PER_S
    assert r.peak_bf16 is device.BF16_FLOPS
    assert r.peak_f32 is device.F32_FLOPS
    assert r.link_bw is device.LINK_BYTES_PER_S
    assert smoke.HBM_BYTES_PER_S is device.HBM_BYTES_PER_S
    assert smoke.BF16_FLOPS is device.BF16_FLOPS
    assert smoke.F32_FLOPS is device.F32_FLOPS


def test_page_bytes_of_the_served_bf16_pages():
    """qwen3-0.6B at block 16: 65,536 B fp against 16,512 B frozen a page
    and layer (4-bit codes + two 16-entry f32 codebooks)."""
    cfg = get_config("qwen3_0_6b")
    pb = page_bytes(cfg, 16, quantized=True, num_values=16)
    assert pb["fp"] == 65_536 * cfg.n_layers
    assert pb["frozen"] == 16_512 * cfg.n_layers


@pytest.mark.parametrize("attn_impl", ["fused", "gather"])
def test_modeled_decode_bytes_equal_the_reference(attn_impl):
    pb = {"fp": 65_536 * 28, "frozen": 16_512 * 28}
    table = [[1, 2, 3, 4, 0], [5, 6, 7, 0, 0], [0] * 5, [8, 9, 0, 0, 0]]
    kw = dict(lens=[60, 40, 0, 17], table=table, frozen={1, 2, 5, 8},
              active=[0, 1, 3])
    port = modeled_decode_hbm_bytes(_worker(attn_impl, pb, **kw))
    ref = jax_modeled_decode_hbm_bytes(_worker(attn_impl, pb, **kw))
    assert set(port) == set(ref)
    for k in port:
        if k != "t_memory_s":
            assert port[k] == ref[k], k
    # fused: slot 0 reads 4 pages (2 frozen), slot 1 3 (1), slot 3 2 (1)
    fused = 4 * pb["frozen"] + 5 * pb["fp"]
    assert port["hbm_bytes_step_fused"] == fused
    assert port["hbm_bytes_step_gather"] == 4 * pb["fp"]
    step = fused if attn_impl == "fused" else 4 * pb["fp"]
    assert port["hbm_bytes_per_token"] == step / 3
    assert port["t_memory_s"] == step / 3.35e12
    assert modeled_decode_hbm_bytes(_worker(attn_impl, pb, lens=[0] * 4,
                                            table=table, frozen=(),
                                            active=[])) is None


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("off,chunk", [(0, 64), (64, 64), (192, 64),
                                       (0, 7), (21, 7)])
def test_modeled_prefill_bytes_equal_the_reference(fused, off, chunk):
    pb = {"fp": 65_536, "frozen": 16_512}
    blocks = list(range(3, 3 + 18))
    frozen = {3, 4, 5, 9}
    kw = dict(block_size=16, off=off, chunk=chunk, fused=fused)
    port = modeled_prefill_hbm_bytes(pb, blocks, frozen, **kw)
    ref = jax_modeled_prefill_hbm_bytes(pb, blocks, frozen, **kw)
    assert port["hbm_bytes_chunk"] == ref["hbm_bytes_chunk"]
    assert port["hbm_bytes_per_token"] == ref["hbm_bytes_per_token"]
    assert port["t_memory_s"] == port["hbm_bytes_chunk"] / 3.35e12
