"""Serving engines (port of ``repro/serving/engine.py``):
``ContinuousBatchingEngine``, the colocated composition (one decode worker
plus a prefill worker borrowing its pool), and ``DisaggEngine``, the
disaggregated one (N prefill workers with pools of their own feeding M
decode workers through a global router), each behind a wall-clock run
loop. The disaggregated engine migrates a finished prompt's pages as fp
rows (``migrate="fp"``) or, with a ``kv_quant`` spec that has a device
solver, as packed codes + codebooks solved on the prefill worker's pool
(``migrate="frozen"``), which land installed.

Overload (``serving.overload``), on either engine: ``offload_pages``
demotes a preemption victim's pages to a host tier and restores them
exactly, ``preempt`` evicts a best_effort sequence when a latency request
is blocked on capacity (restore or recompute by the cost model), and
``admission="slo"`` sheds best_effort arrivals while the windowed
inter-token p99 breaches ``itl_slo_s`` and defers them while the pool is
nearly full. With all three off the run loops take none of that path and
the summary holds no overload key.

``attn_impl`` picks the read path of decode steps and prefill chunks:
"fused" goes through the hand-written paged-attention kernel (frozen pages
dequantized on chip), "gather" expands pages to dense K/V first, and
"auto" is fused on CUDA and gather on the CPU. A fused CUDA engine
raises when it is built if the kernel refuses the pool's head_dim, block
size or codebook width (``kernels.paged_attention.shape_refusal``),
naming the shape.

``speculate=k`` with ``draft=(params, cfg)`` (see
``serving.speculative.derive_draft``) turns every decode iteration into a
draft-propose / batched-verify / accept-rollback step: k draft tokens per
sequence, one (B, k+1) verify window on the target, accepted prefixes
advance ``seq_lens`` in place, rejected suffixes roll back (never freezing
a page past the accepted watermark). Greedy only: the emitted trace is
the non-speculative engine's greedy trace.

``prefix_cache=True`` shares full prompt pages across sequences whose
prompts share a page-aligned prefix: published pages (installed-frozen on
a quantized pool, full prompt pages on an fp pool) are spliced into a new
sequence's table at a refcount, its prefill starts past them, and
admission charges worst-case pages minus the shareable ones.

``kv_quant`` is a QuantSpec (object or string like "kmeans_ls@16"),
validated at construction. ``prefill_chunk=C`` splits every admitted
prompt into C-token chunks and advances one chunk per engine iteration,
interleaved with decode steps for the live batch.

Each run's summary reports ``paged_attention_launches`` and
``quant_matmul_launches``, the two kernels' launches during the run, and
``qmatmul_dequant_fallback``, the dense-materialization fallbacks of
quantized projections (0 certifies that every PTQ'd matmul served from
codes).

``tracer=`` (an ``obs.Tracer``; ``NullTracer`` by default) records the
run on one track per component: the router's admit/defer/reject, the
prefill workers' dispatch/harvest, the decode steps' dispatch/sync/commit,
page transfers, the page-freeze and page-offload lifecycles as async spans
and the cache and roofline counters. ``exporter=`` (an
``obs.MetricsExporter``) snapshots the metrics every iteration its
interval allows and once at the end, and turns on the workers' modeled
HBM gauges (``hbm_bytes_per_token``, ``t_memory_s``).

The engine runs on the card by default (``device="cuda"``, which raises
without a GPU); ``device="cpu"`` runs it on the host.
"""
from __future__ import annotations

import time
from collections import deque

import torch

from repro_torch.core import device_methods
from repro_torch.device import resolve_device
from repro_torch.kernels import paged_decode_attention, quant_matmul
from repro_torch.kernels.paged_attention import shape_refusal
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.quant.serve import fallback_count

from .kv_cache import resolve_kv_spec
from .metrics import MetricsCollector
from .overload import OverloadManager, SLOAdmission
from .scheduler import DisaggRouter, Request, make_requests
from .workers import DecodeWorker, PrefillWorker


def _make_overload(metrics, *, offload_pages: bool, preempt: bool,
                   admission: str, itl_slo_s: float | None, router=None):
    """The overload machinery of either engine: None when every overload
    feature is off, else an ``OverloadManager`` with an SLO policy when
    ``admission`` is "slo"."""
    if admission not in ("fcfs", "slo"):
        raise ValueError(f"admission {admission!r}: fcfs or slo")
    if not (offload_pages or preempt or admission == "slo"):
        return None
    policy = (SLOAdmission(metrics, itl_slo_s=itl_slo_s)
              if admission == "slo" else None)
    return OverloadManager(offload_pages=offload_pages, policy=policy,
                           router=router)


def _slo_door(om, req, occupancy: float, metrics, rejected: list,
              now: float, tracer) -> bool | None:
    """The SLO policy's verdict on an arrival that passed the never-fits
    door: False if shed (counted, rejected), True if deferred (arrival
    metered, parked in ``om.deferred``), None to admit as usual. Each
    verdict is an instant on the "router" track."""
    if om is None or om.policy is None:
        return None
    verdict = om.policy.decide(req, occupancy=occupancy)
    if verdict == "shed":
        rejected.append(req.id)
        metrics.admission("shed_slo")
        tracer.instant("router", "reject", rid=req.id, reason="shed_slo")
        return False
    if verdict == "defer":
        om.deferred.append(req)
        metrics.arrival(req.id, now, req.prompt_len)
        metrics.admission("deferred")
        tracer.instant("router", "defer", rid=req.id,
                       deferred=len(om.deferred))
        return True
    return None


def _retire_demoted(om, outputs: dict) -> None:
    """End of run: release every host-tier entry still demoted (its
    request finished or was cancelled while offloaded, or never restored),
    so both tiers drain; its output is what it emitted before eviction."""
    if om is None:
        return
    for entry in om.store.entries():
        om.retire(entry.req.id)
        outputs.setdefault(entry.req.id, list(entry.out))


def _offload_compression(summary: dict) -> None:
    """What the host tier saved against demoting at fp width."""
    if summary.get("offload_bytes"):
        summary["offload_compression"] = (summary["offload_fp_equiv_bytes"]
                                          / summary["offload_bytes"])


def _resolve_attn_impl(attn_impl: str, device: torch.device, *,
                       head_dim: int, block_size: int,
                       num_values: int | None) -> str:
    """The read path for a pool of this geometry on ``device``
    (``num_values=None``: an fp pool). A fused path on CUDA raises when
    the kernel refuses the pool; the CPU runs the kernel's plain
    version, which takes any pool."""
    if attn_impl not in ("auto", "fused", "gather"):
        raise ValueError(f"attn_impl {attn_impl!r}: auto, fused or gather")
    if attn_impl == "auto":
        attn_impl = "fused" if device.type == "cuda" else "gather"
    if attn_impl == "fused" and device.type == "cuda":
        refusal = shape_refusal(head_dim, block_size, num_values,
                                packed=num_values is None
                                or num_values <= 16)
        if refusal:
            raise ValueError(f"attn_impl='fused' on CUDA: the "
                             f"paged-attention kernel refuses this pool: "
                             f"{refusal}")
    return attn_impl


class _LaunchCounts:
    """The kernels' launches and the dense fallbacks since construction:
    a run's summary reports their differences."""

    def __init__(self):
        self.attn0 = paged_decode_attention.launches
        self.qmm0, self.fb0 = quant_matmul.launches, fallback_count()

    def into(self, summary: dict, metrics) -> None:
        summary["paged_attention_launches"] = (
            paged_decode_attention.launches - self.attn0)
        summary["quant_matmul_launches"] = quant_matmul.launches - self.qmm0
        fallbacks = fallback_count() - self.fb0
        summary["qmatmul_dequant_fallback"] = fallbacks
        metrics.stats.counter("qmatmul_dequant_fallback").inc(fallbacks)


def _tokens_per_step(summary: dict) -> None:
    """Decode-generated tokens per sequence decode step: 1.0 without
    speculation, more when verify windows accept drafts."""
    if summary.get("seq_decode_steps"):
        summary["tokens_per_step"] = ((summary.get("gen_tokens", 0)
                                       - summary.get("completed", 0))
                                      / summary["seq_decode_steps"])


class ContinuousBatchingEngine:
    """Colocated serving: decode worker + pool-borrowing prefill worker."""

    def __init__(self, params, cfg, *, device="cuda", max_slots: int = 8,
                 block_size: int = 16, max_seq_len: int = 256,
                 num_blocks: int | None = None, kv_quant=None,
                 kv_num_values: int | None = None, max_queue: int = 256,
                 eos_id: int | None = None, record_logits: bool = False,
                 attn_impl: str = "auto", freeze_async: bool = True,
                 freeze_page_budget: int = 4, speculate: int = 0,
                 draft: tuple | None = None,
                 prefill_chunk: int | None = None,
                 prefix_cache: bool = False, tracer=None, exporter=None,
                 offload_pages: bool = False, preempt: bool = False,
                 admission: str = "fcfs", itl_slo_s: float | None = None):
        if cfg.family != "lm":
            raise ValueError("paged serving drives decoder-only LMs")
        self.device = resolve_device(device)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.exporter = exporter
        # fail fast: an unfreezable spec raises here, naming the methods
        # that can freeze pages
        self.kv_spec = (None if kv_quant is None else
                        resolve_kv_spec(kv_quant, num_values=kv_num_values))
        self.attn_impl = _resolve_attn_impl(
            attn_impl, self.device, head_dim=cfg.head_dim,
            block_size=block_size,
            num_values=None if self.kv_spec is None
            else self.kv_spec.num_values)
        self.speculate = speculate
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
            eos_id=eos_id, record_logits=record_logits, speculate=speculate,
            draft=draft, prefix_cache=prefix_cache, metrics=self.metrics,
            outputs=self.outputs, request_logits=self.request_logits,
            tracer=self.tracer, roofline_gauges=exporter is not None)
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
        self.preempt = preempt
        self.overload = _make_overload(
            self.metrics, offload_pages=offload_pages, preempt=preempt,
            admission=admission, itl_slo_s=itl_slo_s)

    @property
    def counters(self):
        return self.worker.counters

    def submit(self, req: Request, now: float) -> bool:
        if self.speculate and req.temperature > 0.0:
            raise ValueError(
                "speculative decoding serves the greedy (temperature=0) "
                "verification path; submit sampled requests to a "
                "non-speculative engine")
        w = self.worker
        if w.fits(req):
            # the SLO door comes after the never-fits one: a request no
            # pool could hold is a rejection, not a shed
            occ = 1.0 - w.alloc.num_free / (w.num_blocks - 1)
            verdict = _slo_door(self.overload, req, occ, self.metrics,
                                w.sched.rejected, now, self.tracer)
            if verdict is not None:
                return verdict
        ok = w.submit(req, now)
        # the colocated scheduler's admission is the routing decision: it
        # lands on the "router" track, as the disaggregated router's does
        self.tracer.instant("router", "admit" if ok else "reject",
                            rid=req.id)
        return ok

    @torch.inference_mode()
    def run(self, requests: list[Request], *, poll_s: float = 0.002) -> dict:
        """Serve a trace (arrival_time = seconds from start). Wall-clock
        driven: a request becomes visible when the loop's clock passes its
        arrival; the loop sleeps only when idle. The summary carries this
        run's kernel launches and dequant fallbacks."""
        w, om = self.worker, self.overload
        launches = _LaunchCounts()
        pending = deque(sorted(requests, key=lambda r: (r.arrival_time, r.id)))
        t0 = time.perf_counter()
        now_fn = lambda: time.perf_counter() - t0
        busy = lambda: (w.sched.has_work or bool(self._chunking)
                        or (om is not None and om.has_work))
        while pending or busy():
            now = now_fn()
            while pending and pending[0].arrival_time <= now:
                self.submit(pending.popleft(), now)
            if not busy():
                if not pending:     # everything left was rejected
                    break
                nxt = pending[0].arrival_time
                time.sleep(min(max(nxt - now, 0.0), poll_s) or poll_s)
                continue
            if om is not None:
                # restore ahead of admission: an offloaded sequence
                # re-enters (its pages landed before the decode step that
                # reads them) ahead of every queued arrival
                om.retry_deferred(w)
                om.try_restore(w, now_fn)
            # with the prefix cache on, admission charges each request its
            # worst case minus the prompt pages already shareable (its
            # prefill splices those instead of allocating them)
            disc = w.prefix_probe if w.prefix is not None else None
            for st in w.sched.schedule(w.alloc.num_free, discount=disc):
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
            if om is not None and self.preempt:
                om.maybe_preempt(w, now_fn)
            w.step(now_fn)
            if self.exporter is not None:
                self.exporter.maybe_emit(self.metrics)
        w.drain()
        _retire_demoted(om, self.outputs)
        if self.exporter is not None:
            self.exporter.maybe_emit(self.metrics, force=True)
        out = self.metrics.summary()
        out["page_compression"] = w._pb["fp"] / w._pb["frozen"]
        out["rejected"] = len(w.sched.rejected)
        out["attn_impl"] = self.attn_impl
        out.update(w.counters)
        if w.draft is not None:
            out.update(w.draft.counters, draft_layers=w.draft.cfg.n_layers)
        out["prefill_chunks"] = self.prefill.counters["prefill_chunks"]
        launches.into(out, self.metrics)
        _tokens_per_step(out)
        _offload_compression(out)
        out["speculate"] = self.speculate
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


class DisaggEngine:
    """Disaggregated serving: ``prefill_workers`` prefill workers, each with
    an fp pool of its own (``prefill_blocks`` pages, default twice a
    longest prompt's plus the null page), feed ``decode_workers`` decode
    workers through a global ``DisaggRouter``; a finished prompt's pages
    migrate to the decode worker's pool as fp rows (``migrate="fp"``) or
    as codes + codebooks solved on the prefill worker's (quantized) pool
    (``migrate="frozen"``, which needs a ``kv_quant`` with a device
    solver). Every decode
    worker owns its pool and its freeze stream on the same card, and all
    of them share one ``MetricsCollector`` and one outputs dict. The
    decode options are the colocated engine's, but for chunked prefill
    and prefix sharing, which the reference does not compose with
    migration either.

    A prefill is harvested once the card has finished it, so which decode
    steps run before a prompt joins the batch depends on the card's and
    the host's speed, and with it the step at which a budgeted freeze
    quantizes each page. ``block_prefill`` harvests every prefill in the
    iteration that dispatched it, waiting for the card: the schedule is
    then the CPU's on every machine, which replays that compare two
    engines need."""

    def __init__(self, params, cfg, *, device="cuda",
                 prefill_workers: int = 1, decode_workers: int = 1,
                 migrate: str = "fp", max_slots: int = 8,
                 block_size: int = 16, max_seq_len: int = 256,
                 num_blocks: int | None = None,
                 prefill_blocks: int | None = None, kv_quant=None,
                 kv_num_values: int | None = None, max_queue: int = 256,
                 staging_depth: int | None = None, eos_id: int | None = None,
                 record_logits: bool = False, attn_impl: str = "auto",
                 freeze_async: bool = True, freeze_page_budget: int = 4,
                 speculate: int = 0, draft: tuple | None = None,
                 tracer=None, exporter=None, offload_pages: bool = False,
                 preempt: bool = False, admission: str = "fcfs",
                 itl_slo_s: float | None = None,
                 block_prefill: bool = False):
        if cfg.family != "lm":
            raise ValueError("paged serving drives decoder-only LMs")
        if prefill_workers < 1 or decode_workers < 1:
            raise ValueError(f"{prefill_workers} prefill and "
                             f"{decode_workers} decode workers: want >= 1 "
                             f"of each")
        if migrate not in ("fp", "frozen"):
            raise ValueError(f"migrate must be 'fp' or 'frozen', got "
                             f"{migrate!r} (splice is the colocated "
                             f"composition, resident the host tier's)")
        self.device = resolve_device(device)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.exporter = exporter
        self.kv_spec = (None if kv_quant is None else
                        resolve_kv_spec(kv_quant, num_values=kv_num_values))
        if migrate == "frozen":
            if self.kv_spec is None:
                raise ValueError(
                    "migrate='frozen' ships pages as codes + codebooks and "
                    "needs a kv_quant spec (e.g. kmeans_ls@16)")
            if not self.kv_spec.device_capable:
                raise ValueError(
                    f"migrate='frozen' solves pages through the batched "
                    f"device freeze; {self.kv_spec.method} has no device "
                    f"solver, use one of: {', '.join(device_methods())}")
        self.attn_impl = _resolve_attn_impl(
            attn_impl, self.device, head_dim=cfg.head_dim,
            block_size=block_size,
            num_values=None if self.kv_spec is None
            else self.kv_spec.num_values)
        self.params, self.cfg = params, cfg
        self.migrate = migrate
        self.speculate = speculate
        self.record_logits = record_logits
        self.metrics = MetricsCollector()
        self.outputs: dict[int, list[int]] = {}
        self.request_logits: dict[int, object] = {}
        self.decode = [DecodeWorker(
            params, cfg, device=self.device, worker_id=i,
            max_slots=max_slots, block_size=block_size,
            max_seq_len=max_seq_len, num_blocks=num_blocks,
            kv_spec=self.kv_spec, attn_impl=self.attn_impl,
            freeze_async=freeze_async,
            freeze_page_budget=freeze_page_budget, max_queue=max_queue,
            eos_id=eos_id, record_logits=record_logits, speculate=speculate,
            draft=draft, metrics=self.metrics, outputs=self.outputs,
            request_logits=self.request_logits, tracer=self.tracer,
            roofline_gauges=exporter is not None)
            for i in range(decode_workers)]
        self.prefills = [PrefillWorker(
            params, cfg, device=self.device, worker_id=i,
            block_size=block_size, max_seq_len=max_seq_len, migrate=migrate,
            kv_spec=self.kv_spec, num_blocks=prefill_blocks,
            record_logits=record_logits, metrics=self.metrics,
            tracer=self.tracer)
            for i in range(prefill_workers)]
        self.router = DisaggRouter(max_queue=max_queue,
                                   staging_depth=staging_depth,
                                   tracer=self.tracer)
        self._launches = _LaunchCounts()
        self.block_size = block_size
        self.max_seq_len = self.decode[0].max_seq_len
        self.freeze_async = self.decode[0].freeze_async
        self.eos_id = eos_id
        self.preempt = preempt
        self.block_prefill = block_prefill
        self.overload = _make_overload(
            self.metrics, offload_pages=offload_pages, preempt=preempt,
            admission=admission, itl_slo_s=itl_slo_s, router=self.router)

    @property
    def counters(self) -> dict:
        """The decode workers' counters summed (``max_gather_blocks``: the
        largest)."""
        agg: dict = {}
        for dw in self.decode:
            for k, v in dw.counters.items():
                agg[k] = (max(agg.get(k, 0), v) if k == "max_gather_blocks"
                          else agg.get(k, 0) + v)
        return agg

    def submit(self, req: Request, now: float) -> bool:
        if self.speculate and req.temperature > 0.0:
            raise ValueError(
                "speculative decoding serves the greedy (temperature=0) "
                "verification path; submit sampled requests to a "
                "non-speculative engine")
        d0, p0 = self.decode[0], self.prefills[0]
        if (not d0.fits(req)
                or -(-req.prompt_len // self.block_size)
                > p0.num_blocks - 1):
            # what no worker can ever hold would block the router's
            # queues forever
            self.router.rejected.append(req.id)
            self.metrics.admission("rejected_pool_full")
            self.tracer.instant("router", "reject", rid=req.id,
                                reason="never_fits")
            return False
        # the request may land on any decode worker: the policy reads the
        # least occupied one
        occ = min(1.0 - d.alloc.num_free / (d.num_blocks - 1)
                  for d in self.decode)
        verdict = _slo_door(self.overload, req, occ, self.metrics,
                            self.router.rejected, now, self.tracer)
        if verdict is not None:
            return verdict
        ok = self.router.submit(req)
        if ok:
            self.metrics.arrival(req.id, now, req.prompt_len)
        else:
            self.metrics.admission("rejected_queue_full")
        return ok

    @property
    def _has_work(self) -> bool:
        return (self.router.has_work or any(p.busy for p in self.prefills)
                or any(d.sched.has_work or d.has_work for d in self.decode)
                or (self.overload is not None and self.overload.has_work))

    @torch.inference_mode()
    def run(self, requests: list[Request], *, poll_s: float = 0.002) -> dict:
        """Serve a trace (arrival_time = seconds from start). One loop
        iteration: route waiting requests onto prefill workers, advance
        each prefill worker (dispatch or harvest, never waiting for the
        card), place finished prefills onto decode workers, then one
        decode step per decode worker with work. Decode never waits on a
        prefill. With overload on, deferred retries and restores run
        first (a payload restores onto any decode worker with room), and
        a preemption check runs before the decode steps."""
        self._launches = _LaunchCounts()
        om = self.overload
        pending = deque(sorted(requests, key=lambda r: (r.arrival_time, r.id)))
        t0 = time.perf_counter()
        now_fn = lambda: time.perf_counter() - t0

        def place(dw, fin):
            st = dw.sched.admit_direct(fin.req)
            if st is None:          # the router checked can_accept
                raise RuntimeError(f"decode worker {dw.worker_id} has no "
                                   f"free slot for request {fin.req.id}")
            dw.attach(st, fin, now_fn())

        while pending or self._has_work:
            now = now_fn()
            while pending and pending[0].arrival_time <= now:
                self.submit(pending.popleft(), now)
            if not self._has_work:
                if not pending:     # everything left was rejected
                    break
                nxt = pending[0].arrival_time
                time.sleep(min(max(nxt - now, 0.0), poll_s) or poll_s)
                continue
            progressed = False
            if om is not None:
                om.retry_deferred(max(self.decode,
                                      key=lambda d: d.alloc.num_free))
                for dw in self.decode:
                    progressed |= bool(om.try_restore(dw, now_fn))
            self.router.route_prefill(self.prefills)
            for pw in self.prefills:
                for fin in pw.step(now_fn, block=self.block_prefill):
                    self.router.stage(fin)
                    progressed = True
            progressed |= bool(self.router.route_decode(self.decode, place))
            if om is not None and self.preempt:
                for dw in self.decode:
                    progressed |= om.maybe_preempt(dw, now_fn)
            for dw in self.decode:
                if dw.has_work:
                    dw.step(now_fn)
                    progressed = progressed or bool(dw.sched.active)
            if self.exporter is not None:
                self.exporter.maybe_emit(self.metrics)
            if not progressed:
                # only in-flight prefills to wait on: let the card work
                time.sleep(poll_s / 4)
        for dw in self.decode:
            dw.drain()
        _retire_demoted(om, self.outputs)
        if self.exporter is not None:
            self.exporter.maybe_emit(self.metrics, force=True)
        return self._summary()

    def _summary(self) -> dict:
        out = self.metrics.summary()
        out.update(self.counters)
        if self.speculate:
            for dw in self.decode:
                for k, v in dw.draft.counters.items():
                    out[k] = out.get(k, 0) + v
            out["draft_layers"] = self.decode[0].draft.cfg.n_layers
        out["prefills_done"] = sum(p.counters["prefills"]
                                   for p in self.prefills)
        out["migrate_solves"] = sum(p.counters["migrate_solves"]
                                    for p in self.prefills)
        out["prefill_chunks"] = 0
        self._launches.into(out, self.metrics)
        out["rejected"] = len(self.router.rejected)
        out["attn_impl"] = self.attn_impl
        out["migrate"] = self.migrate
        _tokens_per_step(out)
        out["speculate"] = self.speculate
        out["prefill_workers"] = len(self.prefills)
        out["decode_workers"] = len(self.decode)
        out["per_worker"] = {
            "prefill": [{k: p.counters[k] for k in
                         ("prefills", "migrated_pages", "migrate_bytes",
                          "migrate_solves")}
                        for p in self.prefills],
            "decode": [{k: d.counters[k] for k in
                        ("migrated_seqs", "migrated_pages", "migrate_bytes")}
                       for d in self.decode]}
        pb = self.decode[0]._pb
        out["page_compression"] = pb["fp"] / pb["frozen"]
        out["migrate_compression"] = (
            out["migrate_fp_equiv_bytes"] / out["migrate_bytes"]
            if out.get("migrate_bytes") else 1.0)
        _offload_compression(out)
        return out

    def generate(self, prompts: list[list[int]], max_new_tokens: int,
                 *, temperature: float = 0.0, top_k: int = 0,
                 seed: int | None = None) -> dict:
        """Batch convenience, as the colocated engine's."""
        self.run(make_requests(prompts, max_new_tokens,
                               temperature=temperature, top_k=top_k,
                               seed=seed))
        return {i: self.outputs.get(i) for i in range(len(prompts))}
