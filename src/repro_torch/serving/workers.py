"""Serving workers: the decode role and the prefill role over one paged
pool (port of ``repro/serving/workers.py``, colocated composition).

``DecodeWorker`` owns the paged pool and the decode hot loop: iteration
batching over its slots, async page freezing (batched kmeans_ls solves,
rate-limited per decode step) and slot recycling, behind ``step()`` /
``attach()``. ``PrefillWorker`` borrows the decode worker's pool and
allocator and turns admitted prompts into finished prefills, whole
(``run_inline``) or chunk by chunk (``start_chunked``/``advance_chunk``).

Speculative decoding, preemption/restore, prefix sharing, the owned-pool
(disaggregated) prefill mode and its page payloads come in later slices.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import models
from repro_torch.obs.trace import NULL_TRACER

from .kv_cache import (BlockAllocator, dispatch_freeze, freeze_blocks,
                       init_paged_cache, install_freeze, page_bytes,
                       thaw_blocks, with_prefill_fused, with_tables)
from .metrics import MetricsCollector
from .scheduler import ContinuousBatchingScheduler, Request, SeqState


def sample_token(row: np.ndarray, *, temperature: float = 0.0,
                 top_k: int = 0, rng=None) -> int:
    """Sampling over one vocab row of logits: temperature <= 0 is greedy
    argmax; otherwise softmax at ``temperature`` over the ``top_k`` largest
    logits (0 = all), drawn from the request's own Generator."""
    if temperature <= 0.0 or rng is None:
        return int(np.argmax(row))
    logits = np.asarray(row, np.float64) / temperature
    if 0 < top_k < logits.size:
        kth = np.partition(logits, -top_k)[-top_k]
        logits = np.where(logits >= kth, logits, -np.inf)
    p = np.exp(logits - logits.max())
    return int(rng.choice(logits.size, p=p / p.sum()))


@dataclasses.dataclass
class FinishedPrefill:
    """What a prefill hands the decode worker: the sampled first token
    (and its logits when recorded), the sampler state, and the sequence's
    pages, already resident in the shared pool."""

    req: Request
    first_token: int
    blocks: list
    rng: np.random.Generator
    last_logits: np.ndarray | None = None


class _Slot:
    """Decode-worker per-slot state (token io + page bookkeeping)."""

    def __init__(self):
        self.rid = None
        self.blocks: list[int] = []
        self.frozen_upto = 0          # block-table slots already queued
        self.last_token = 0
        self.out: list[int] = []
        self.logits: list[np.ndarray] = []
        self.rng = None
        self.temperature = 0.0
        self.top_k = 0


class DecodeWorker:
    """The decode role: paged pool + iteration-batched decode loop + async
    freeze machinery, fed through ``attach(seq_state, finished_prefill)``."""

    def __init__(self, params, cfg, *, device, max_slots: int = 8,
                 block_size: int = 16, max_seq_len: int = 256,
                 num_blocks: int | None = None, kv_spec=None,
                 attn_impl: str = "gather", freeze_async: bool = True,
                 freeze_page_budget: int = 4, max_queue: int = 256,
                 eos_id: int | None = None, record_logits: bool = False,
                 metrics=None, outputs=None, request_logits=None,
                 tracer=None):
        if freeze_page_budget < 1:
            raise ValueError("freeze budget must cover >= 1 page")
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._trk_decode, self._trk_freeze = "decode/w0", "freeze/w0"
        self.params, self.cfg = params, cfg
        self.device = torch.device(device)
        self.kv_spec = kv_spec
        self.attn_impl = attn_impl
        self.block_size = block_size
        self.max_blocks = -(-max_seq_len // block_size)
        self.max_seq_len = self.max_blocks * block_size
        self.num_blocks = (num_blocks if num_blocks is not None
                           else max_slots * self.max_blocks + 1)
        self.freeze_async = freeze_async and kv_spec is not None
        self.freeze_page_budget = freeze_page_budget
        self.eos_id = eos_id
        self.record_logits = record_logits
        self.pool = init_paged_cache(
            cfg, num_blocks=self.num_blocks, block_size=block_size,
            quantized=kv_spec is not None,
            num_values=16 if kv_spec is None else kv_spec.num_values,
            fused=attn_impl == "fused", device=self.device)
        self.alloc = BlockAllocator(self.num_blocks)
        self.sched = ContinuousBatchingScheduler(
            max_slots=max_slots, block_size=block_size, max_queue=max_queue)
        self.metrics = metrics if metrics is not None else MetricsCollector()
        self.table = np.zeros((max_slots, self.max_blocks), np.int32)
        self.lens = np.zeros((max_slots,), np.int32)
        self.slots = [_Slot() for _ in range(max_slots)]
        self.outputs = outputs if outputs is not None else {}
        self.request_logits = (request_logits if request_logits is not None
                               else {})
        self._pb = page_bytes(cfg, block_size, quantized=kv_spec is not None,
                              num_values=16 if kv_spec is None
                              else kv_spec.num_values)
        # freeze/decode overlap accounting; freeze_deferred_pages counts
        # pages pushed past their iteration by the per-step freeze budget
        self.counters = {"freeze_dispatches": 0, "freeze_installs": 0,
                         "decode_steps": 0, "seq_decode_steps": 0,
                         "freeze_inflight_steps": 0, "freeze_overlap_steps": 0,
                         "freeze_pending_max": 0, "freeze_deferred_pages": 0,
                         "max_gather_blocks": 0}
        self._pending_freezes: list[tuple[int, object]] = []
        self._freeze_bids: list[int] = []   # queued for the next flush
        self._deferred_seen = 0    # queue suffix already counted deferred
        self._frozen_pages: set[int] = set()   # installed (codes serving)

    # ------------------------------------------------------------ intake

    def fits(self, req: Request) -> bool:
        """Whether this worker could ever hold the request."""
        return not (req.prompt_len + req.max_new_tokens > self.max_seq_len
                    or self.sched.blocks_for(req) > self.num_blocks - 1)

    def submit(self, req: Request, now: float) -> bool:
        """Admission control + queueing + arrival metric."""
        if not self.fits(req):
            self.sched.rejected.append(req.id)
            self.metrics.admission("rejected_pool_full")
            return False
        ok = self.sched.submit(req)
        if ok:
            self.metrics.arrival(req.id, now, req.prompt_len)
        else:
            self.metrics.admission("rejected_queue_full")
        return ok

    @property
    def has_work(self) -> bool:
        return bool(self.sched.active or self._pending_freezes
                    or self._freeze_bids)

    def attach(self, st: SeqState, fin: FinishedPrefill, now: float) -> None:
        """Start decoding a finished prefill at slot ``st.slot``."""
        req, s = st.req, self.slots[st.slot]
        P = req.prompt_len
        s.rid, s.blocks = req.id, list(fin.blocks)
        s.out, s.logits = [fin.first_token], []
        s.last_token = fin.first_token
        s.rng, s.temperature, s.top_k = fin.rng, req.temperature, req.top_k
        if self.record_logits and fin.last_logits is not None:
            s.logits.append(fin.last_logits)
        self.table[st.slot] = 0
        self.table[st.slot, :len(s.blocks)] = s.blocks
        self.lens[st.slot] = P
        st.length, st.generated = P, 1
        s.frozen_upto = 0
        self._queue_freeze(st.slot)
        if st.done or fin.first_token == self.eos_id:
            self._finish(st, now)

    # ------------------------------------------------------------ steps

    def step(self, now_fn) -> None:
        """One engine iteration: flush queued freezes (budgeted), one
        batched decode step, occupancy sample. With no live sequence the
        decode step is skipped but pending freezes are still polled."""
        self._flush_freezes()
        if self.sched.active_slots():
            self._decode_step(now_fn)
        else:
            self._poll_freezes()
        self._sample_cache()

    def _decode_step(self, now_fn) -> None:
        active = self.sched.active_slots()
        tr = self.tracer
        t_step = tr.now()
        self.counters["decode_steps"] += 1
        self.counters["seq_decode_steps"] += len(active)
        self._poll_freezes()
        toks = np.zeros((len(self.slots), 1), np.int32)
        for i in active:
            toks[i, 0] = self.slots[i].last_token
        # read only the blocks the longest live sequence needs this step
        need = int(self.lens.max()) + 1
        mb_used = max(1, -(-need // self.block_size))
        self.counters["max_gather_blocks"] = max(
            self.counters["max_gather_blocks"], mb_used)
        t0 = tr.now()
        views = with_tables(self.pool, self.table[:, :mb_used], self.lens)
        logits, _ = models.decode_step(
            # lint: sync(pageable copy of the step's token ids; ROADMAP A2)
            self.params, self.cfg, torch.as_tensor(toks).to(self.device),
            views, views[0].seq_lens)
        tr.complete(self._trk_decode, "dispatch", t0, blocks=mb_used)
        t0 = tr.now()
        last = logits[:, -1]
        # lint: sync(step-end token sync: the scheduler needs the ids)
        nxt = last.argmax(-1).cpu().numpy()
        sampling = any(self.slots[i].temperature > 0.0 for i in active)
        # lint: sync(the same sync: host sampling or recorded logits)
        rows = (last.cpu().numpy() if self.record_logits or sampling
                else None)
        tr.complete(self._trk_decode, "sync", t0)
        now = now_fn()
        finished = []
        for i in active:
            st = self.sched.active[i]
            s = self.slots[i]
            self.lens[i] += 1
            st.length += 1
            st.generated += 1
            s.last_token = (sample_token(rows[i], temperature=s.temperature,
                                         top_k=s.top_k, rng=s.rng)
                            if s.temperature > 0.0 else int(nxt[i]))
            s.out.append(s.last_token)
            if self.record_logits:
                s.logits.append(rows[i])
            self.metrics.token(st.req.id, now)
            self._queue_freeze(i)
            if st.done or s.last_token == self.eos_id:
                finished.append(st)
        for st in finished:
            self._finish(st, now)
        tr.complete(self._trk_decode, "decode_step", t_step,
                    step=self.counters["decode_steps"], active=len(active))

    # ------------------------------------------------------------ freezing

    def _poll_freezes(self, drain: bool = False) -> None:
        """Install completed freezes; count the ones still overlapping this
        decode step. drain=True waits for the remainder (end of run)."""
        still = []
        for step0, pending in self._pending_freezes:
            if drain:
                pending.wait()
            if pending.is_ready():
                install_freeze(self.pool, pending)
                self._frozen_pages.update(pending.kept_pages())
                self.counters["freeze_installs"] += 1
                self.counters["freeze_overlap_steps"] += (
                    self.counters["decode_steps"] - step0)
            else:
                self.counters["freeze_inflight_steps"] += 1
                still.append((step0, pending))
        self._pending_freezes = still

    def _queue_freeze(self, slot: int) -> None:
        """Queue this sequence's just-filled pages for quantization; the
        next flush solves the whole queue in one batched call."""
        if self.kv_spec is None:
            return
        s = self.slots[slot]
        full = int(self.lens[slot]) // self.block_size
        for j in range(s.frozen_upto, full):
            b = int(self.table[slot, j])
            if b not in self._frozen_pages and b not in self._freeze_bids:
                self._freeze_bids.append(b)
        s.frozen_upto = max(s.frozen_upto, full)

    def _flush_freezes(self) -> None:
        """One batched solve for queued pages, rate-limited to
        ``freeze_page_budget`` pages per decode step: a prefill burst
        queues a whole prompt's pages at once, and the remainder flushes on
        later iterations (deferred pages serve exact fp until then)."""
        if not self._freeze_bids:
            return
        tr = self.tracer
        t0 = tr.now()
        take = min(len(self._freeze_bids), self.freeze_page_budget)
        bids, self._freeze_bids = (self._freeze_bids[:take],
                                   self._freeze_bids[take:])
        # count each page's deferral once
        self._deferred_seen = max(self._deferred_seen - take, 0)
        newly = len(self._freeze_bids) - self._deferred_seen
        if newly > 0:
            self.counters["freeze_deferred_pages"] += newly
        self._deferred_seen = len(self._freeze_bids)
        # pad to a power-of-two page count (repeating one page is a no-op
        # at install): the solver sees a handful of batch shapes
        bucket = 1 << (len(bids) - 1).bit_length()
        bids = bids + [bids[-1]] * (bucket - len(bids))
        if self.freeze_async:
            pending = dispatch_freeze(self.pool, bids, self.kv_spec)
            self._pending_freezes.append(
                (self.counters["decode_steps"], pending))
            self.counters["freeze_pending_max"] = max(
                self.counters["freeze_pending_max"],
                len(self._pending_freezes))
        else:
            freeze_blocks(self.pool, bids, self.kv_spec)
            self._frozen_pages.update(bids)
            self.counters["freeze_installs"] += 1
        self.counters["freeze_dispatches"] += 1
        tr.complete(self._trk_freeze, "flush", t0, pages=take,
                    mode="async" if self.freeze_async else "sync")

    # ------------------------------------------------------------ teardown

    def _finish(self, st: SeqState, now: float) -> None:
        slot, s = st.slot, self.slots[st.slot]
        self.outputs[st.req.id] = list(s.out)
        if self.record_logits and s.logits:
            self.request_logits[st.req.id] = np.stack(s.logits)
        self.metrics.finish(st.req.id, now)
        released = set(self.alloc.free(s.blocks))
        self._freeze_bids = [b for b in self._freeze_bids
                             if b not in released]
        self._deferred_seen = min(self._deferred_seen, len(self._freeze_bids))
        self._frozen_pages -= released
        for _, pending in self._pending_freezes:
            pending.drop(released)
        thaw_blocks(self.pool, released)
        self.table[slot] = 0
        self.lens[slot] = 0
        s.rid, s.blocks, s.frozen_upto, s.out = None, [], 0, []
        s.rng, s.temperature, s.top_k = None, 0.0, 0
        self.sched.release(st)

    def drain(self) -> None:
        """Flush every queued freeze and land in-flight solves (end of
        run)."""
        while self._freeze_bids:
            self._flush_freezes()
        self._poll_freezes(drain=True)

    def _sample_cache(self) -> None:
        allocated = (self.num_blocks - 1) - self.alloc.num_free
        # installed pages only: queued/in-flight solves still serve fp
        frozen = len(self._frozen_pages)
        actual = (frozen * self._pb["frozen"]
                  + (allocated - frozen) * self._pb["fp"])
        occ = allocated / (self.num_blocks - 1)
        self.metrics.sample_cache(occ, actual, allocated * self._pb["fp"])


@dataclasses.dataclass
class _ChunkedPrefill:
    """In-flight chunked prefill: one prompt advancing chunk by chunk so
    the engine can interleave decode steps between chunks."""

    req: Request
    blocks: list
    toks: np.ndarray          # (1, ppad) zero-padded prompt
    nblk: int
    off: int = 0              # tokens already in cache
    last_row: object = None   # logits row at prompt position P-1

    @property
    def done(self) -> bool:
        return self.off >= self.toks.shape[1]


class PrefillWorker:
    """The prefill role, colocated: prompts prefill straight into the
    decode worker's pool with blocks from its allocator, so the handoff to
    decode is just the block ids."""

    def __init__(self, params, cfg, *, pool: DecodeWorker,
                 record_logits: bool = False, metrics=None,
                 prefill_chunk: int | None = None, tracer=None):
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1 token")
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._trk = "prefill/w0"
        self.params, self.cfg = params, cfg
        self.pool = pool
        self.block_size = pool.block_size
        self.record_logits = record_logits
        self.prefill_chunk = prefill_chunk
        self.metrics = metrics if metrics is not None else MetricsCollector()
        self.counters = {"prefills": 0, "prefill_chunks": 0}

    def _alloc(self, req: Request, now_fn):
        self.metrics.prefill_start(req.id, now_fn())
        ppad = -(-req.prompt_len // self.block_size) * self.block_size
        blocks = self.pool.alloc.alloc(self.pool.sched.blocks_for(req))
        toks = np.zeros((1, ppad), np.int32)
        toks[0, :req.prompt_len] = req.prompt
        return blocks, toks, ppad // self.block_size

    def _finish(self, req: Request, blocks, last, now_fn) -> FinishedPrefill:
        last = last.cpu().numpy()  # lint: sync(first-token sampling)
        now = now_fn()                        # TTFT includes prefill time
        rng = req.make_rng()
        tok = sample_token(last, temperature=req.temperature,
                           top_k=req.top_k, rng=rng)
        self.metrics.first_token(req.id, now)
        self.counters["prefills"] += 1
        return FinishedPrefill(
            req=req, first_token=tok, blocks=[int(b) for b in blocks],
            rng=rng, last_logits=last if self.record_logits else None)

    def run_inline(self, req: Request, now_fn) -> FinishedPrefill:
        """Synchronous whole-prompt prefill (the gather read path)."""
        tr = self.tracer
        t0 = tr.now()
        blocks, toks, nblk = self._alloc(req, now_fn)
        views = with_tables(self.pool.pool,
                            np.asarray([blocks[:nblk]], np.int32),
                            np.zeros((1,), np.int32))
        logits, _ = models.prefill(
            self.params, self.cfg,
            # lint: sync(pageable copy of the prompt's ids; ROADMAP A2)
            {"tokens": torch.as_tensor(toks).to(self.pool.device)}, views)
        tr.complete(self._trk, "prefill", t0, rid=req.id,
                    prompt_len=req.prompt_len)
        return self._finish(req, blocks, logits[0, req.prompt_len - 1],
                            now_fn)

    def start_chunked(self, req: Request, now_fn) -> _ChunkedPrefill:
        """Open a chunked prefill: allocate the request's worst-case pages
        and return the chunk cursor; the engine then calls
        ``advance_chunk`` once per iteration, between decode steps."""
        if not self.prefill_chunk:
            raise ValueError("start_chunked needs prefill_chunk")
        blocks, toks, nblk = self._alloc(req, now_fn)
        return _ChunkedPrefill(req=req, blocks=blocks, toks=toks, nblk=nblk)

    def advance_chunk(self, state: _ChunkedPrefill,
                      now_fn) -> FinishedPrefill | None:
        """Run ONE chunk; returns the finished prefill once the whole
        (padded) prompt is in cache, else None. Positions and the chunk
        offset are explicit, so the chunk sequence computes what one
        whole-prompt prefill computes; with the fused impl each chunk reads
        earlier frozen pages as packed codes through the kernel."""
        tr = self.tracer
        t0 = tr.now()
        req, P = state.req, state.req.prompt_len
        ppad = state.toks.shape[1]
        off = state.off
        C = min(self.prefill_chunk, ppad - off)
        dev = self.pool.device
        # lint: sync(pageable copy of the chunk's ids; ROADMAP A2)
        toks = torch.as_tensor(state.toks[:, off:off + C]).to(dev)
        pos = torch.arange(off, off + C, dtype=torch.int32,
                           device=dev)[None]
        views = with_tables(self.pool.pool,
                            np.asarray([state.blocks[:state.nblk]], np.int32),
                            np.full((1,), off, np.int32))
        if self.pool.attn_impl == "fused":
            views = with_prefill_fused(views)
        logits, _ = models.prefill(self.params, self.cfg,
                                   {"tokens": toks, "positions": pos}, views)
        if off <= P - 1 < off + C:
            state.last_row = logits[0, P - 1 - off]
        state.off = off + C
        self.counters["prefill_chunks"] += 1
        tr.complete(self._trk, "prefill_chunk", t0, rid=req.id, off=off,
                    chunk=C)
        if not state.done:
            return None
        return self._finish(req, state.blocks, state.last_row, now_fn)
