"""Continuous-batching serving engine (port of ``repro/serving/engine.py``,
the colocated composition): one decode worker plus a prefill worker
borrowing its pool, behind a wall-clock run loop.

``attn_impl`` picks the read path of decode steps and prefill chunks:
"fused" goes through the hand-written paged-attention kernel (frozen pages
dequantized on chip), "gather" expands pages to dense K/V first, and
"auto" is fused on CUDA and gather on the CPU.

``kv_quant`` is a QuantSpec (object or string like "kmeans_ls@16"),
validated at construction. ``prefill_chunk=C`` splits every admitted
prompt into C-token chunks and advances one chunk per engine iteration,
interleaved with decode steps for the live batch.

Each run's summary reports ``paged_attention_launches`` and
``quant_matmul_launches``, the two kernels' launches during the run, and
``qmatmul_dequant_fallback``, the dense-materialization fallbacks of
quantized projections (0 certifies that every PTQ'd matmul served from
codes).

The engine runs on the card by default (``device="cuda"``, which raises
without a GPU); ``device="cpu"`` runs it on the host.
"""
from __future__ import annotations

import time
from collections import deque

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import paged_decode_attention, quant_matmul
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.quant.serve import fallback_count

from .kv_cache import resolve_kv_spec
from .metrics import MetricsCollector
from .scheduler import Request, make_requests
from .workers import DecodeWorker, PrefillWorker


def _resolve_attn_impl(attn_impl: str, device: torch.device) -> str:
    if attn_impl not in ("auto", "fused", "gather"):
        raise ValueError(f"attn_impl {attn_impl!r}: auto, fused or gather")
    if attn_impl == "auto":
        return "fused" if device.type == "cuda" else "gather"
    return attn_impl


class ContinuousBatchingEngine:
    """Colocated serving: decode worker + pool-borrowing prefill worker."""

    def __init__(self, params, cfg, *, device="cuda", max_slots: int = 8,
                 block_size: int = 16, max_seq_len: int = 256,
                 num_blocks: int | None = None, kv_quant=None,
                 kv_num_values: int | None = None, max_queue: int = 256,
                 eos_id: int | None = None, record_logits: bool = False,
                 attn_impl: str = "auto", freeze_async: bool = True,
                 freeze_page_budget: int = 4,
                 prefill_chunk: int | None = None, tracer=None):
        if cfg.family != "lm":
            raise ValueError("paged serving drives decoder-only LMs")
        self.device = resolve_device(device)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.attn_impl = _resolve_attn_impl(attn_impl, self.device)
        # fail fast: an unfreezable spec raises here, naming the methods
        # that can freeze pages
        self.kv_spec = (None if kv_quant is None else
                        resolve_kv_spec(kv_quant, num_values=kv_num_values))
        self.params, self.cfg = params, cfg
        self.record_logits = record_logits
        self.metrics = MetricsCollector()
        self.outputs: dict[int, list[int]] = {}
        self.request_logits: dict[int, object] = {}
        self.worker = DecodeWorker(
            params, cfg, device=self.device, max_slots=max_slots,
            block_size=block_size, max_seq_len=max_seq_len,
            num_blocks=num_blocks, kv_spec=self.kv_spec,
            attn_impl=self.attn_impl, freeze_async=freeze_async,
            freeze_page_budget=freeze_page_budget, max_queue=max_queue,
            eos_id=eos_id, record_logits=record_logits, metrics=self.metrics,
            outputs=self.outputs, request_logits=self.request_logits,
            tracer=self.tracer)
        self.prefill = PrefillWorker(
            params, cfg, pool=self.worker, record_logits=record_logits,
            metrics=self.metrics, prefill_chunk=prefill_chunk,
            tracer=self.tracer)
        self.prefill_chunk = prefill_chunk
        # admitted sequences mid-chunk: out of the decode batch (slot and
        # pages reserved), one chunk per engine iteration
        self._chunking: deque = deque()
        self.block_size = block_size
        self.max_seq_len = self.worker.max_seq_len
        self.freeze_async = self.worker.freeze_async
        self.eos_id = eos_id

    @property
    def counters(self):
        return self.worker.counters

    def submit(self, req: Request, now: float) -> bool:
        return self.worker.submit(req, now)

    @torch.inference_mode()
    def run(self, requests: list[Request], *, poll_s: float = 0.002) -> dict:
        """Serve a trace (arrival_time = seconds from start). Wall-clock
        driven: a request becomes visible when the loop's clock passes its
        arrival; the loop sleeps only when idle. The summary carries this
        run's kernel launches and dequant fallbacks."""
        w = self.worker
        launches0 = paged_decode_attention.launches
        qmm0, fallbacks0 = quant_matmul.launches, fallback_count()
        pending = deque(sorted(requests, key=lambda r: (r.arrival_time, r.id)))
        t0 = time.perf_counter()
        now_fn = lambda: time.perf_counter() - t0
        while pending or w.sched.has_work or self._chunking:
            now = now_fn()
            while pending and pending[0].arrival_time <= now:
                self.submit(pending.popleft(), now)
            if not (w.sched.has_work or self._chunking):
                if not pending:     # everything left was rejected
                    break
                nxt = pending[0].arrival_time
                time.sleep(min(max(nxt - now, 0.0), poll_s) or poll_s)
                continue
            for st in w.sched.schedule(w.alloc.num_free):
                if self.prefill_chunk:
                    self._chunking.append(
                        (st, self.prefill.start_chunked(st.req, now_fn)))
                    w.sched.stage(st)
                else:
                    fin = self.prefill.run_inline(st.req, now_fn)
                    w.attach(st, fin, now_fn())
            if self._chunking:
                # one chunk per iteration (FCFS head), so decode steps for
                # live sequences interleave between chunks of a long prompt
                st, state = self._chunking[0]
                fin = self.prefill.advance_chunk(state, now_fn)
                if fin is not None:
                    self._chunking.popleft()
                    w.sched.activate(st)
                    w.attach(st, fin, now_fn())
            w.step(now_fn)
        w.drain()
        out = self.metrics.summary()
        out["page_compression"] = w._pb["fp"] / w._pb["frozen"]
        out["rejected"] = len(w.sched.rejected)
        out["attn_impl"] = self.attn_impl
        out.update(w.counters)
        out["prefill_chunks"] = self.prefill.counters["prefill_chunks"]
        out["paged_attention_launches"] = (paged_decode_attention.launches
                                           - launches0)
        out["quant_matmul_launches"] = quant_matmul.launches - qmm0
        fallbacks = fallback_count() - fallbacks0
        out["qmatmul_dequant_fallback"] = fallbacks
        self.metrics.stats.counter("qmatmul_dequant_fallback").inc(fallbacks)
        if out.get("seq_decode_steps"):
            out["tokens_per_step"] = ((out.get("gen_tokens", 0)
                                       - out.get("completed", 0))
                                      / out["seq_decode_steps"])
        return out

    def generate(self, prompts: list[list[int]], max_new_tokens: int,
                 *, temperature: float = 0.0, top_k: int = 0,
                 seed: int | None = None) -> dict:
        """Batch convenience: all requests arrive at t=0; returns outputs
        (None for requests rejected by admission control)."""
        self.run(make_requests(prompts, max_new_tokens,
                               temperature=temperature, top_k=top_k,
                               seed=seed))
        return {i: self.outputs.get(i) for i in range(len(prompts))}
