"""The serving driver: one cell of the program's continuous-batching engine
(``ContinuousBatchingEngine``: chunked prefill, paged KV whose full pages
freeze to 16-value codebooks, read through the paged-attention kernel,
projections served from PTQ'd codes through the dequant-matmul kernel).

Set-up: seeded weights on the device, the program's PTQ of every
projection (``quantize_tree``, timed as ``ptq_s``), the engine, and a
warm-up of two requests through it (two prefill chunks each and enough
decode steps to freeze pages), which loads every kernel the window runs.

Window: an ``open_loop`` mix is one ``engine.run`` over the seeded
arrivals in ``[0, seconds)``, drained to its end; a ``batches`` mix runs
batches due at once until ``seconds`` have passed, the last one to its
end. The window's wall time ends with the last token, and an open-loop
window lasts at least ``seconds``, the span of its arrivals.

Then the reference judges a sample of the served requests
(``reference/judge.py``) against the cell's limit in
``portbench/checks/<workload>.json``.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.reference import judge
from portbench.reference.model import quantized_weights
from portbench.yardstick import traffic
from portbench.yardstick.profiling import DeviceTrace
from portbench.yardstick.stats import percentile
from portbench.yardstick.weights import make_weights

WARM_ID = 10 ** 9


def _check_dims(cfg, dims: dict) -> None:
    """The program's config must be the model the file states."""
    have = {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
            "qk_norm": cfg.qk_norm, "tie_embeddings": cfg.tie_embeddings,
            "rope_theta": cfg.rope_theta, "dtype": cfg.param_dtype}
    bad = {k: (v, dims[k]) for k, v in have.items() if v != dims[k]}
    if bad:
        raise SystemExit(f"[portbench] the program's {cfg.name} is not the "
                         f"configuration's model: {bad}")


def _requests(Request, reqs: list[dict]) -> list:
    return [Request(id=r["id"], prompt=tuple(int(t) for t in r["prompt"]),
                    max_new_tokens=r["max_new"],
                    arrival_time=r["arrival"]) for r in reqs]


def _warmup(eng, Request, engine: dict, vocab: int, seed: int) -> None:
    rng = np.random.default_rng((seed, 1))
    P = engine["prefill_chunk"] + engine["block_size"] + 1
    n = 2 * engine["block_size"] + 1
    eng.run([Request(id=WARM_ID + i, prompt=tuple(
        rng.integers(0, vocab, P).tolist()), max_new_tokens=n)
        for i in range(2)])


def _records(eng, reqs: list[dict], e0: float) -> list[dict]:
    """Per request, on the host's perf_counter clock: scheduled arrival,
    first token, every token's time, queue wait, what was served."""
    out = []
    for r in reqs:
        tr = eng.metrics.traces.get(r["id"])
        served = eng.outputs.get(r["id"]) or []
        rec = {"id": r["id"], "prompt": r["prompt"], "max_new": r["max_new"],
               "arrival": e0 + r["arrival"], "served": list(served),
               "first": None, "token_times": [], "gaps": [],
               "queue_wait": None}
        if tr is not None and tr.first_token_t is not None:
            first = e0 + tr.first_token_t
            rec["first"] = first
            rec["gaps"] = list(tr.gaps)
            rec["token_times"] = list(first + np.concatenate(
                [[0.0], np.cumsum(tr.gaps)]))
            rec["queue_wait"] = tr.queue_wait
        out.append(rec)
    return out


def _spans(tracer, origin: float) -> list[dict]:
    """The tracer's complete events on the perf_counter clock (the
    warm-up's among them: the caller keeps the window's)."""
    names = {}
    for ev in tracer.to_dict()["traceEvents"]:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[ev["tid"]] = ev["args"]["name"]
    out = []
    for ev in tracer.events:
        if ev.get("ph") != "X":
            continue
        start = origin + ev["ts"] * 1e-6
        out.append({"name": ev["name"], "track": names.get(ev["tid"], ""),
                    "start": start, "end": start + ev["dur"] * 1e-6,
                    "args": ev.get("args", {})})
    return out


def run(job: dict) -> dict:
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.obs import Tracer
    from repro_torch.quant import quantize_tree
    from repro_torch.serving import ContinuousBatchingEngine, Request

    conf, mix, cpu = job["config"], job["mix"], job["cpu"]
    dims = conf["cpu_dry_run"]["dims"] if cpu else conf["dims"]
    cfg = (get_reduced_config if cpu else get_config)(conf["program_arch"])
    _check_dims(cfg, dims)
    dev = torch.device("cpu" if cpu else "cuda")
    dtype = getattr(torch, dims["dtype"])
    seed, seconds = job["seed"], job["seconds"]
    engine = mix["engine"]

    weights = make_weights(dims, seed, dev, dtype)
    t = time.perf_counter()
    qparams, _ = quantize_tree(weights, conf["ptq"],
                               skip_patterns=conf["ptq_skip"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ptq_s = time.perf_counter() - t
    del weights
    tracer = Tracer() if job["trace"] else None
    eng = ContinuousBatchingEngine(qparams, cfg, device=dev,
                                   kv_quant=conf["kv_quant"], tracer=tracer,
                                   **engine)
    _warmup(eng, Request, engine, dims["vocab"], seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    dt = DeviceTrace() if job["trace"] and dev.type == "cuda" else None
    origin = None
    if tracer is not None:
        t_mark = time.perf_counter()
        tracer.instant("portbench", "origin")
        origin = t_mark - tracer.events[-1]["ts"] * 1e-6
    prof = mix["profile"]
    if dt is not None:
        dt.arm()
        worker_step = eng.worker.step

        def step(now_fn):
            # the profile starts at the first step past from_s and ends
            # at the first step ``seconds`` after its start
            now = time.perf_counter()
            if dt.t0 is None and now - w0 >= prof["from_s"]:
                dt.mark()
            elif dt.active and now - dt.t0 >= prof["seconds"]:
                dt.mark()
            worker_step(now_fn)

        eng.worker.step = step

    records = []
    if mix["kind"] == "open_loop":
        reqs = traffic.open_loop(mix, seed, seconds, dims["vocab"])
        window = _requests(Request, reqs)
    w0 = time.perf_counter()
    setup_s = w0 - job["t_proc"]
    if mix["kind"] == "open_loop":
        e0 = time.perf_counter()
        eng.run(window)
        records = _records(eng, reqs, e0)
        # the offered load spans [0, seconds): an idle end is window too
        w_end = w0 + seconds
    else:
        w_end = w0
        for batch in traffic.batches(mix, seed, dims["vocab"]):
            e0 = time.perf_counter()
            eng.run(_requests(Request, batch))
            records += _records(eng, batch, e0)
            if time.perf_counter() - w0 >= seconds:
                break
    w1 = max(time.perf_counter(), w_end)
    if dt is not None:
        dt.finish()
        eng.worker.step = worker_step
        worker_step = step = None       # no reference to the pool is left
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    spans = ([sp for sp in _spans(tracer, origin) if sp["start"] >= w0]
             if tracer is not None else [])
    device = (dt.reduce(spans) if dt is not None and dt.t0 is not None
              else None)
    if device is not None:
        device["span"] = (dt.t0, dt.t1)
        notes_prof = {"profile_from_s": dt.t0 - w0}
    else:
        notes_prof = {}

    del eng, qparams
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference: its own weights from the seed, its own PTQ, then a
    # sample of the served requests
    kv_values = int(conf["kv_quant"].split("@")[1])
    ptq_values = int(conf["ptq"].split("@")[1])
    ref_w = quantized_weights(make_weights(dims, seed, dev, dtype), dims,
                              ptq_values)
    done = [r for r in records if len(r["served"]) == r["max_new"]]
    picked = judge.sample(done, mix["check"]["requests"], seed)
    check = judge.readings(ref_w, dims, picked,
                           block=engine["block_size"], num_values=kv_values,
                           device=dev, control=job.get("control"))
    notes = {**_notes(records, w0, w1, seconds), **notes_prof,
             "positions_checked": check.pop("positions")}
    return {"notes": notes,
            "records": records, "window": (w0, w1), "setup_s": setup_s,
            "ptq_s": ptq_s, "spans": spans, "device_trace": device,
            "memory_peak": int(memory_peak), "dims": dims,
            "attempted": len(records), "failed": len(records) - len(done),
            "check": check}


def _notes(records: list[dict], w0: float, w1: float,
           seconds: float) -> dict:
    """What the window held beside its metrics (the rate sweep reads
    them): requests still in the system when arrivals closed, the queue
    wait's p90, the median TTFT, the drain."""
    close = w0 + seconds
    waits = [r["queue_wait"] for r in records if r["queue_wait"] is not None]
    return {"requests": len(records),
            "in_flight_at_close": sum(
                1 for r in records if r["arrival"] < close
                and (not r["token_times"] or r["token_times"][-1] > close)),
            "queue_wait_p90_s": percentile(waits, 90),
            "ttft_p50_s": percentile([r["first"] - r["arrival"]
                                      for r in records if r["first"]], 50),
            "drain_s": max(w1 - close, 0.0), "window_s": w1 - w0,
            "served_tokens": sum(len(r["served"]) for r in records)}
