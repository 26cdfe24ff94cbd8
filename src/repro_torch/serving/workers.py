"""Serving workers: the decode role and the prefill role (port of
``repro/serving/workers.py``).

``DecodeWorker`` owns a paged pool and the decode hot loop: iteration
batching over its slots, async page freezing (batched kmeans_ls solves,
rate-limited per decode step) and slot recycling, behind ``step()`` /
``attach()``. Sequences enter it only as finished prefills
(``transfer.FinishedPrefill``): a splice payload's pages already live in
its pool, a migration payload's pages are spliced in at fresh blocks
(frozen ones land installed). Under overload ``preempt`` evicts a live
sequence at a step boundary, demoting its pages to a host payload or
dropping them for a recompute, and ``restore`` lands them again
(``serving.overload``). With
``speculate=k`` every decode iteration is a draft propose
(``speculative.DraftWorker``), one batched (B, k+1) verify window on the
target, and a per-slot accept/rollback. With ``prefix_cache`` the worker
publishes shareable full prompt pages into a ``PrefixIndex``, and later
prompts splice them at a refcount instead of prefilling them.

``PrefillWorker`` turns prompts into finished prefills in one of two
compositions:

  owned pool (disaggregated)   ``pool=None``: the worker prefills into its
      own pool, extracts the pages as an fp payload, or (``migrate=
      "frozen"``) solves the full pages on that pool's side stream behind
      the prefill and ships codes + codebooks, and frees its blocks.
      ``step()`` dispatches at most one prefill and harvests it on a later
      call, once the card is done with the prefill and the solve, so the
      caller's decode loop never waits on a prompt.

  borrowed pool (colocated)    ``pool=<DecodeWorker>``: prompts prefill
      straight into the decode worker's pool with blocks from its
      allocator, whole (``run_inline``) or chunk by chunk
      (``start_chunked``/``advance_chunk``), starting past any spliced
      shared pages; the handoff is a "splice" payload of block ids.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch import models
from repro_torch.obs.export import (modeled_decode_hbm_bytes,
                                    modeled_prefill_hbm_bytes)
from repro_torch.obs.trace import NULL_TRACER

from .kv_cache import (BlockAllocator, PrefixIndex, dispatch_freeze,
                       freeze_blocks, init_paged_cache, install_freeze,
                       page_bytes, thaw_blocks, with_prefill_fused,
                       with_tables)
from .metrics import MetricsCollector
from .overload import ResumeEntry
from .scheduler import ContinuousBatchingScheduler, Request, SeqState
from .speculative import DraftWorker, window_step
from .transfer import (FinishedPrefill, extract_pages,
                       extract_resident_pages, splice_of, splice_payload)


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


def prefill_chunk(params, cfg, pool, toks: np.ndarray, blocks, off: int, *,
                  fused: bool):
    """Prefill the prompt slice ``toks`` (1, C) at token offset ``off``
    into ``pool`` over ``blocks``: explicit positions, so it computes what
    the matching rows of a whole-prompt prefill compute; ``fused`` reads
    earlier pages (frozen ones as packed codes) through the kernel.
    Returns logits (1, C, V)."""
    dev = pool.device
    C = toks.shape[1]
    pos = torch.arange(off, off + C, dtype=torch.int32, device=dev)[None]
    views = with_tables(pool, np.asarray([blocks], np.int32),
                        np.full((1,), off, np.int32))
    if fused:
        views = with_prefill_fused(views)
    logits, _ = models.prefill(
        params, cfg,
        # lint: sync(pageable copy of the chunk's ids; ROADMAP A2)
        {"tokens": torch.as_tensor(toks).to(dev), "positions": pos}, views)
    return logits


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

    def __init__(self, params, cfg, *, device, worker_id: int = 0,
                 max_slots: int = 8, block_size: int = 16,
                 max_seq_len: int = 256,
                 num_blocks: int | None = None, kv_spec=None,
                 attn_impl: str = "gather", freeze_async: bool = True,
                 freeze_page_budget: int = 4, max_queue: int = 256,
                 eos_id: int | None = None, record_logits: bool = False,
                 speculate: int = 0, draft: tuple | None = None,
                 prefix_cache: bool = False, metrics=None, outputs=None,
                 request_logits=None, tracer=None,
                 roofline_gauges: bool = False):
        if freeze_page_budget < 1:
            raise ValueError("freeze budget must cover >= 1 page")
        if speculate < 0:
            raise ValueError(f"speculate={speculate}: want >= 0")
        if speculate:
            if draft is None:
                raise ValueError("speculate=k needs draft=(params, cfg): "
                                 "see serving.speculative.derive_draft")
            if draft[1].vocab != cfg.vocab:
                raise ValueError(
                    f"draft vocab {draft[1].vocab} != target {cfg.vocab}; "
                    f"speculative verify compares token ids directly")
            if attn_impl == "fused" and speculate + 1 > block_size:
                raise ValueError(
                    f"speculate={speculate} verify window exceeds block "
                    f"size {block_size}; the fused-window gate would also "
                    f"catch prefill steps")
        self.speculate = speculate
        self.worker_id = worker_id
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # the modeled HBM gauges each step, also untraced (a metrics
        # exporter reads them); a run with neither skips the host walk
        self.roofline_gauges = roofline_gauges
        self._trk_decode = f"decode/w{worker_id}"
        self._trk_freeze = f"freeze/w{worker_id}"
        self._trk_spec = f"spec/w{worker_id}"
        self.params, self.cfg = params, cfg
        self.device = torch.device(device)
        self.kv_spec = kv_spec
        self.attn_impl = attn_impl
        self.block_size = block_size
        self.max_blocks = -(-max_seq_len // block_size)
        self.max_seq_len = self.max_blocks * block_size
        self.num_blocks = (num_blocks if num_blocks is not None
                           else max_slots * self.max_blocks + 1)
        # a per-page host freeze is complete when dispatched: it installs
        # at once, as the reference's does
        self.freeze_async = (freeze_async and kv_spec is not None
                             and kv_spec.device_capable)
        self.freeze_page_budget = freeze_page_budget
        self.eos_id = eos_id
        self.record_logits = record_logits
        self.pool = init_paged_cache(
            cfg, num_blocks=self.num_blocks, block_size=block_size,
            quantized=kv_spec is not None,
            num_values=16 if kv_spec is None else kv_spec.num_values,
            fused=attn_impl == "fused", fused_window=speculate + 1,
            device=self.device)
        self.alloc = BlockAllocator(self.num_blocks)
        # `lookahead` reserves the verify window's optimistic rows past
        # max_new_tokens in the worst-case page count
        self.sched = ContinuousBatchingScheduler(
            max_slots=max_slots, block_size=block_size, max_queue=max_queue,
            lookahead=speculate)
        self.draft = None if not speculate else DraftWorker(
            draft[0], draft[1], device=self.device, max_slots=max_slots,
            block_size=block_size, max_blocks=self.max_blocks,
            worker_id=worker_id, tracer=self.tracer)
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
        # freeze/decode overlap and migration accounting;
        # freeze_deferred_pages counts pages pushed past their iteration by
        # the per-step freeze budget; host_page_solves counts the per-page
        # host freeze's row solves (0 with a batched device solver)
        self.counters = {"freeze_dispatches": 0, "freeze_installs": 0,
                         "host_page_solves": 0, "decode_steps": 0,
                         "seq_decode_steps": 0,
                         "freeze_inflight_steps": 0, "freeze_overlap_steps": 0,
                         "freeze_pending_max": 0, "freeze_deferred_pages": 0,
                         "max_gather_blocks": 0, "migrated_seqs": 0,
                         "migrated_pages": 0, "migrate_bytes": 0,
                         "migrate_fp_equiv_bytes": 0,
                         # prefix sharing: prefills that matched a published
                         # run, the pages they spliced instead of
                         # prefilling, and write-hot tail pages prefilled
                         # privately instead of shared (copy-on-write)
                         "prefix_hits": 0, "prefix_shared_pages": 0,
                         "cow_copies": 0,
                         # overload: evictions and the host-tier traffic
                         # they caused
                         "preemptions": 0, "preempt_offloads": 0,
                         "preempt_recomputes": 0, "offloaded_pages": 0,
                         "offload_bytes": 0, "offload_fp_equiv_bytes": 0,
                         "restored_seqs": 0, "restored_pages": 0,
                         "restore_bytes": 0}
        # hash-chain index over installed-frozen (or, unquantized, full
        # prompt) pages; prefills splice published pages at rc + 1
        self.prefix = PrefixIndex(block_size) if prefix_cache else None
        self._pending_freezes: list[tuple[int, object]] = []
        self._freeze_bids: list[int] = []   # queued for the next flush
        self._deferred_seen = 0    # queue suffix already counted deferred
        self._frozen_pages: set[int] = set()   # installed (codes serving)
        # freeze-lifecycle async spans: page id -> open span id. A span
        # opens when a bid is queued and ends in exactly one terminal
        # state: installed, dropped (its sequence left first), rolled_back
        # (a rejected speculative suffix) or offloaded (its sequence was
        # demoted to the host tier)
        self._page_spans: dict[int, int] = {}
        self._span_seq = 0
        # overload: the decode step at which each slot last emitted (the
        # LRU signal, seeded at attach and restore), and a recompute
        # requeue's tokens from its first life, merged back at finish
        self.last_attended: dict[int, int] = {}
        self._resume_prefix: dict[int, tuple[list, list]] = {}

    # ------------------------------------------------------------ intake

    def fits(self, req: Request) -> bool:
        """Whether this worker could ever hold the request (the verify
        window's lookahead rows included)."""
        return not (req.prompt_len + req.max_new_tokens + self.speculate
                    > self.max_seq_len
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

    def can_accept(self, req: Request) -> bool:
        """Router probe: a free slot and the request's worst-case pages."""
        return (bool(self.sched._free_slots)
                and self.sched.blocks_for(req) <= self.alloc.num_free)

    @property
    def free_slots(self) -> int:
        return len(self.sched._free_slots)

    @property
    def has_work(self) -> bool:
        return bool(self.sched.active or self._pending_freezes
                    or self._freeze_bids)

    def attach(self, st: SeqState, fin: FinishedPrefill, now: float) -> None:
        """Start decoding a finished prefill at slot ``st.slot``.

        A "splice" payload (colocated) carries blocks already living in
        this pool; a migration payload allocates the request's worst-case
        blocks here and lands the prompt pages in the first of them (the
        rest fill during decode). A frozen payload's full pages land
        installed; otherwise the full pages then queue for freezing, on
        this pool's own side stream."""
        req, s = st.req, self.slots[st.slot]
        payload = fin.payload
        if payload.mode == "splice":
            blocks = list(payload.blocks)
        else:
            blocks = self.alloc.alloc(self.sched.blocks_for(req))
            splice_payload(self.pool, payload, blocks, tracer=self.tracer)
            self.counters["migrated_seqs"] += 1
            self.counters["migrated_pages"] += payload.n_pages
            self.counters["migrate_bytes"] += payload.nbytes
            self.counters["migrate_fp_equiv_bytes"] += payload.fp_equiv_bytes
        P = req.prompt_len
        s.rid, s.blocks = req.id, blocks
        s.out, s.logits = [fin.first_token], []
        s.last_token = fin.first_token
        s.rng, s.temperature, s.top_k = fin.rng, req.temperature, req.top_k
        if self.record_logits and fin.last_logits is not None:
            s.logits.append(fin.last_logits)
        self.table[st.slot] = 0
        self.table[st.slot, :len(s.blocks)] = s.blocks
        self.lens[st.slot] = P
        st.length, st.generated = P, 1
        # a fresh attach is the coldest preemption candidate at this step
        self.last_attended[st.slot] = self.counters["decode_steps"]
        if payload.mode == "frozen" and payload.n_full:
            # the pages landed as codes + codebooks: never solved again
            s.frozen_upto = payload.n_full
            self._frozen_pages.update(int(b)
                                      for b in blocks[:payload.n_full])
        else:
            # spliced shared pages are installed-frozen: they start the
            # frozen watermark, so they are never queued for a second
            # solve (an fp pool shares exact pages and never freezes)
            s.frozen_upto = (payload.shared_pages if self.kv_spec is not None
                             else 0)
            self._queue_freeze(st.slot)
        if self.draft is not None:
            # the draft prefills the same prompt on its own pool and
            # mirrors this slot
            self.draft.attach(st.slot, req.prompt, len(s.blocks))
        self._publish_prefixes()
        if st.done or fin.first_token == self.eos_id:
            self._finish(st, now)

    # ------------------------------------------------------ prefix sharing

    def _publish_prefixes(self) -> None:
        """(Re)publish every active slot's eligible full prompt pages:
        installed-frozen pages on a quantized pool, every full prompt page
        on an fp pool (prompt rows never rewrite once the sequence is past
        them). Idempotent (the index dedupes on chain key), so calling it
        after every attach, install and finish keeps the index current."""
        if self.prefix is None:
            return
        frozen = self._frozen_pages if self.kv_spec is not None else None
        for i in self.sched.active_slots():
            st = self.sched.active[i]
            self.prefix.publish(st.req.prompt, self.slots[i].blocks, frozen)

    def shared_prefix_pages(self, slot: int) -> int:
        """Length of the slot's leading page run other tables also hold
        (rc > 1). Sharing only splices prefix runs of published chains, so
        refcounts never rise along the table: the first rc == 1 page ends
        the run."""
        if self.prefix is None:
            return 0
        n = 0
        for b in self.slots[slot].blocks:
            if self.alloc.refcount(int(b)) <= 1:
                break
            n += 1
        return n

    def prefix_probe(self, req: Request) -> int:
        """Admission discount: pages of ``req``'s prompt already published
        (lookup only, no retain), which its prefill will splice instead of
        allocating."""
        if self.prefix is None:
            return 0
        return len(self.prefix.lookup(req.prompt,
                                      (req.prompt_len - 1) // self.block_size))

    # ------------------------------------------------------------ steps

    def step(self, now_fn) -> None:
        """One engine iteration: flush queued freezes (budgeted), one
        batched decode step, occupancy sample. With no live sequence the
        decode step is skipped but pending freezes are still polled."""
        self._flush_freezes()
        if self.sched.active_slots():
            if self.speculate:
                self._spec_decode_step(now_fn)
            else:
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
        t0 = tr.now()
        now = now_fn()
        finished = []
        for i in active:
            st = self.sched.active[i]
            s = self.slots[i]
            self.last_attended[i] = self.counters["decode_steps"]
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
        tr.complete(self._trk_decode, "commit", t0, finished=len(finished))
        tr.complete(self._trk_decode, "decode_step", t_step,
                    step=self.counters["decode_steps"], active=len(active))

    # ------------------------------------------------------- speculative

    def _spec_decode_step(self, now_fn) -> None:
        """One speculative iteration: k draft proposals per active slot,
        ONE batched verify window on the target over all k+1 positions,
        then per-slot accept/rollback.

        The verify pass writes all k+1 KV rows, and this method advances
        ``lens`` (and queues freeze bids) optimistically before acceptance
        is known; ``_rollback_slot`` then shrinks every slot back to its
        accepted watermark, un-queueing bids for rolled-back pages. Bids
        flush at the start of the next ``step()``, so a bid queued here
        never dispatches before its rollback: no page is frozen past the
        accepted ``seq_lens`` at any step boundary. Every emitted token is
        the target's greedy argmax for its exact accepted context."""
        active = self.sched.active_slots()
        if any(self.slots[i].temperature > 0.0 for i in active):
            raise ValueError("speculative decoding serves the greedy "
                             "verification path; sampled requests need the "
                             "non-speculative engine")
        tr = self.tracer
        t_step = tr.now()
        k = self.speculate
        W = k + 1
        self.counters["decode_steps"] += 1
        self.counters["seq_decode_steps"] += len(active)
        self._poll_freezes()
        t0 = tr.now()
        proposals = self.draft.propose(active, self.slots, k)
        tr.complete(self._trk_spec, "propose", t0, k=k, active=len(active))
        toks = np.zeros((len(self.slots), W), np.int32)
        for i in active:
            toks[i, 0] = self.slots[i].last_token
            toks[i, 1:] = proposals[i]
        # read only the blocks the longest live sequence's window needs
        need = int(self.lens.max()) + W
        mb_used = max(1, -(-need // self.block_size))
        self.counters["max_gather_blocks"] = max(
            self.counters["max_gather_blocks"], mb_used)
        t0 = tr.now()
        logits = window_step(self.params, self.cfg, toks, self.pool,
                             self.table[:, :mb_used], self.lens)
        # lint: sync(step-end verify sync: acceptance runs on the host)
        preds = logits.argmax(-1).cpu().numpy()               # (B, W)
        # lint: sync(the same sync: recorded logits, off in production)
        rows = logits.cpu().numpy() if self.record_logits else None
        tr.complete(self._trk_spec, "verify", t0, window=W,
                    active=len(active), blocks=mb_used)
        now = now_fn()
        finished = []
        for i in active:
            st = self.sched.active[i]
            s = self.slots[i]
            self.last_attended[i] = self.counters["decode_steps"]
            L = int(self.lens[i])
            # optimistic: all W rows written; advance and queue freezes as
            # if every draft were accepted, then roll back to the watermark
            self.lens[i] = L + W
            self._queue_freeze(i)
            n_acc = 0
            while n_acc < k and proposals[i][n_acc] == int(preds[i, n_acc]):
                n_acc += 1
            # row j of the verify logits is the target's next-token
            # distribution after [ctx, last, d1..dj]: accepted drafts are
            # emitted as they are, and row n_acc gives the correction (or
            # the bonus token when every draft survived)
            emitted = [int(t) for t in proposals[i][:n_acc]]
            emitted.append(int(preds[i, n_acc]))
            emitted = emitted[:st.req.max_new_tokens - st.generated]
            if self.eos_id is not None and self.eos_id in emitted:
                emitted = emitted[:emitted.index(self.eos_id) + 1]
            a = len(emitted)
            self.metrics.spec_step(k, min(n_acc, a), a < W)
            tr.instant(self._trk_spec, "accept", slot=i, rid=st.req.id,
                       proposed=k, accepted=min(n_acc, a), emitted=a)
            if a < W:
                tr.instant(self._trk_spec, "rollback", slot=i,
                           rid=st.req.id, to_len=L + a)
            self._rollback_slot(i, L + a)
            st.length = L + a
            st.generated += a
            for j, t in enumerate(emitted):
                s.out.append(t)
                if self.record_logits:
                    s.logits.append(rows[i, j])
                self.metrics.token(st.req.id, now)
            s.last_token = emitted[-1]
            self.draft.sync(i, L + a)
            if st.done or s.last_token == self.eos_id:
                finished.append(st)
        for st in finished:
            self._finish(st, now)
        tr.complete(self._trk_decode, "decode_step", t_step,
                    step=self.counters["decode_steps"], active=len(active),
                    window=W)

    def frozen_past_watermark(self) -> list[tuple[int, int, int, int]]:
        """(page, slot, table index, lens) of every page frozen, queued
        for a freeze or kept by an in-flight solve past its slot's
        accepted ``seq_lens``: the rollback invariant says none exists at
        a step boundary (a just-freed page awaiting its drop is skipped)."""
        page_slot = {}
        for slot, s in enumerate(self.slots):
            for j, b in enumerate(s.blocks):
                page_slot[int(b)] = (slot, j)
        suspect = set(self._frozen_pages) | set(self._freeze_bids)
        for _, pending in self._pending_freezes:
            suspect |= {int(b) for b in pending.bids[pending.keep]}
        out = []
        for b in sorted(suspect & set(page_slot)):
            slot, j = page_slot[b]
            if (j + 1) * self.block_size > int(self.lens[slot]):
                out.append((b, slot, j, int(self.lens[slot])))
        return out

    def _rollback_slot(self, slot: int, new_len: int) -> None:
        """Shrink a slot to its accepted watermark ``new_len``: un-queue
        freeze bids for pages past it and drop them from any in-flight
        solve, so a rejected suffix never leaves a frozen page beyond the
        accepted ``seq_lens``. Rolled-back rows hold rejected drafts' KV:
        masked out past ``lens``, and rewritten in place by the next
        verify window before ``lens`` covers them."""
        s = self.slots[slot]
        full = int(new_len) // self.block_size
        if s.frozen_upto > full:
            stale = {int(self.table[slot, j])
                     for j in range(full, s.frozen_upto)}
            tr = self.tracer
            if tr.enabled:
                for b in sorted(stale):
                    sid = self._page_spans.pop(b, None)
                    if sid is not None:
                        tr.async_end(self._trk_freeze, "page_freeze", sid,
                                     state="rolled_back", page=b)
            self._freeze_bids = [b for b in self._freeze_bids
                                 if b not in stale]
            self._deferred_seen = min(self._deferred_seen,
                                      len(self._freeze_bids))
            for _, pending in self._pending_freezes:
                pending.drop(stale)
            s.frozen_upto = full
        self.lens[slot] = new_len

    # ------------------------------------------------------------ freezing

    def _poll_freezes(self, drain: bool = False) -> None:
        """Install completed freezes; count the ones still overlapping this
        decode step. drain=True waits for the remainder (end of run)."""
        still = []
        installed = False
        for step0, pending in self._pending_freezes:
            if drain:
                pending.wait()
            if pending.is_ready():
                install_freeze(self.pool, pending)
                kept = pending.kept_pages()
                self._frozen_pages.update(kept)
                installed = True
                self.counters["freeze_installs"] += 1
                self.counters["freeze_overlap_steps"] += (
                    self.counters["decode_steps"] - step0)
                tr = self.tracer
                if tr.enabled:
                    tr.instant(self._trk_freeze, "install", pages=len(kept),
                               wait_steps=self.counters["decode_steps"]
                               - step0)
                    for b in kept:
                        sid = self._page_spans.pop(b, None)
                        if sid is not None:
                            tr.async_end(self._trk_freeze, "page_freeze",
                                         sid, state="installed", page=b)
            else:
                self.counters["freeze_inflight_steps"] += 1
                still.append((step0, pending))
        self._pending_freezes = still
        if installed:
            self._publish_prefixes()    # freshly installed pages can share

    def _queue_freeze(self, slot: int) -> None:
        """Queue this sequence's just-filled pages for quantization; the
        next flush solves the whole queue in one batched call."""
        if self.kv_spec is None:
            return
        s = self.slots[slot]
        full = int(self.lens[slot]) // self.block_size
        tr = self.tracer
        for j in range(s.frozen_upto, full):
            b = int(self.table[slot, j])
            # a shared page is already installed, or bid by the sequence
            # that owns its solve: bids dedupe on block id
            if b in self._frozen_pages or b in self._freeze_bids:
                continue
            self._freeze_bids.append(b)
            if tr.enabled:
                self._span_seq += 1
                self._page_spans[b] = self._span_seq
                tr.async_begin(self._trk_freeze, "page_freeze",
                               self._span_seq, page=b, slot=slot)
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
        if tr.enabled:
            for b in bids:
                sid = self._page_spans.get(b)
                if sid is not None:
                    tr.async_instant(self._trk_freeze, "page_freeze", sid,
                                     state="dispatched")
        # count each page's deferral once
        self._deferred_seen = max(self._deferred_seen - take, 0)
        newly = len(self._freeze_bids) - self._deferred_seen
        if newly > 0:
            self.counters["freeze_deferred_pages"] += newly
        self._deferred_seen = len(self._freeze_bids)
        if self.kv_spec.device_capable:
            # pad to a power-of-two page count (repeating one page is a
            # no-op at install): the solver sees a handful of batch shapes;
            # the host freeze solves per page, where a duplicate is waste
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
            pending = freeze_blocks(self.pool, bids, self.kv_spec)
            self._frozen_pages.update(bids)
            self.counters["freeze_installs"] += 1
            self._publish_prefixes()    # synchronous install: shareable now
            if tr.enabled:
                # a synchronous install ends the lifecycle here
                for b in sorted(set(bids)):
                    sid = self._page_spans.pop(b, None)
                    if sid is not None:
                        tr.async_end(self._trk_freeze, "page_freeze", sid,
                                     state="installed", page=b)
        self.counters["host_page_solves"] += pending.host_solves
        self.counters["freeze_dispatches"] += 1
        tr.complete(self._trk_freeze, "flush", t0, pages=take,
                    mode="async" if self.freeze_async else "sync")

    # ------------------------------------------------------------ teardown

    def _finish(self, st: SeqState, now: float) -> None:
        s = self.slots[st.slot]
        # a recompute requeue carries its first life's tokens as prompt:
        # stitch them back, so the caller sees one output stream
        pre_out, pre_logits = self._resume_prefix.pop(st.req.id, ([], []))
        self.outputs[st.req.id] = pre_out + list(s.out)
        if self.record_logits and (pre_logits or s.logits):
            self.request_logits[st.req.id] = np.stack(pre_logits + s.logits)
        self.metrics.finish(st.req.id, now)
        released = self._free_pages(st)
        tr = self.tracer
        if tr.enabled:
            tr.instant(self._trk_decode, "finish", rid=st.req.id,
                       tokens=len(s.out))
            for b in sorted(released):
                sid = self._page_spans.pop(b, None)
                if sid is not None:
                    tr.async_end(self._trk_freeze, "page_freeze", sid,
                                 state="dropped", page=b)
        self._release(st, released)

    def _free_pages(self, st: SeqState) -> set[int]:
        """Drop the slot's reference to each of its pages; returns the
        pages released (a shared page another live table holds stays)."""
        released = set(self.alloc.free(self.slots[st.slot].blocks))
        if self.prefix is not None:
            self.prefix.invalidate(released)
        return released

    def _release(self, st: SeqState, released: set[int]) -> None:
        """Tear a slot down (finish and preempt) after ``_free_pages``:
        the bids, frozen set, pending solves and thaw cover only the pages
        released, and an in-flight solve drops them, so it is never
        installed over their next owner."""
        slot, s = st.slot, self.slots[st.slot]
        self._freeze_bids = [b for b in self._freeze_bids
                             if b not in released]
        self._deferred_seen = min(self._deferred_seen, len(self._freeze_bids))
        self._frozen_pages -= released
        for _, pending in self._pending_freezes:
            pending.drop(released)
        thaw_blocks(self.pool, released)
        if self.draft is not None:
            self.draft.release(slot)
        self.table[slot] = 0
        self.lens[slot] = 0
        s.rid, s.blocks, s.frozen_upto, s.out, s.logits = None, [], 0, [], []
        s.rng, s.temperature, s.top_k = None, 0.0, 0
        self.last_attended.pop(slot, None)
        self.sched.release(st)
        # the leaver may have been a chain's first publisher: invalidate
        # dropped its keys though a survivor may hold an identical live
        # copy; republish so the next lookup still matches
        self._publish_prefixes()

    # ------------------------------------------------------------ overload

    def preempt(self, st: SeqState, mode: str, now: float) -> ResumeEntry:
        """Evict a live sequence at a step boundary (overload).

        "restore": its pages demote to a host payload
        (``extract_resident_pages``: installed-frozen pages as their codes
        and codebooks, the rest fp), staged at once, for an exact resume.
        "recompute": the pages are dropped, and the entry's request is the
        original with everything emitted appended to its prompt (its
        re-prefill re-derives the KV; value-exact only on fp greedy runs).
        Pages other live tables share stay, this sequence dropping its
        reference. The teardown is a finished sequence's, without the
        output and latency events."""
        if mode not in ("restore", "recompute"):
            raise ValueError(f"preempt mode {mode!r}: restore or recompute")
        slot, s, req = st.slot, self.slots[st.slot], st.req
        if st.done or not s.out:
            raise ValueError(f"preempt of request {req.id}: not a live "
                             f"sequence")
        n_tok = int(self.lens[slot])
        tr = self.tracer
        self.counters["preemptions"] += 1
        if mode == "restore":
            sh = self.shared_prefix_pages(slot)
            full = n_tok // self.block_size
            frozen_idx = [j - sh for j in range(sh, full)
                          if int(self.table[slot, j]) in self._frozen_pages]
            payload = extract_resident_pages(
                self.pool, s.blocks[sh:], n_tok - sh * self.block_size,
                frozen_idx, block_size=self.block_size, tracer=tr)
            t_host = tr.now()
            payload.to_host()           # blocks, as the reference's does
            tr.complete("transfer", "to_host", t_host, rid=req.id,
                        mode=payload.mode, bytes=payload.nbytes,
                        fp_equiv_bytes=payload.fp_equiv_bytes,
                        pages=payload.n_pages)
            entry = ResumeEntry(req=req, out=list(s.out),
                                generated=st.generated, n_tokens=n_tok,
                                rng=s.rng, logits=list(s.logits),
                                payload=payload, shared_pages=sh)
            self.counters["preempt_offloads"] += 1
            self.counters["offloaded_pages"] += payload.n_pages
            self.counters["offload_bytes"] += payload.nbytes
            self.counters["offload_fp_equiv_bytes"] += payload.fp_equiv_bytes
            if tr.enabled:
                for j in range(payload.n_pages):
                    self._span_seq += 1
                    entry.span_ids[j] = self._span_seq
                    tr.async_begin(self._trk_freeze, "page_offload",
                                   self._span_seq, rid=req.id, page_pos=j)
        else:
            resume = dataclasses.replace(
                req, prompt=tuple(req.prompt) + tuple(s.out),
                max_new_tokens=req.max_new_tokens - st.generated)
            pre_out, pre_logits = self._resume_prefix.get(req.id, ([], []))
            self._resume_prefix[req.id] = (pre_out + list(s.out),
                                           pre_logits + list(s.logits))
            entry = ResumeEntry(req=resume, out=list(s.out),
                                generated=st.generated, n_tokens=n_tok)
            self.counters["preempt_recomputes"] += 1
        tr.instant(self._trk_decode, "preempt", rid=req.id, slot=slot,
                   mode=mode, tokens=n_tok, pages=len(s.blocks))
        released = self._free_pages(st)
        if tr.enabled:
            # a literal state on each branch keeps the page_freeze
            # lifecycle statically checkable (the span lint pass)
            for b in sorted(released):
                sid = self._page_spans.pop(b, None)
                if sid is None:
                    continue
                if mode == "restore":
                    tr.async_end(self._trk_freeze, "page_freeze", sid,
                                 state="offloaded", page=b)
                else:
                    tr.async_end(self._trk_freeze, "page_freeze", sid,
                                 state="dropped", page=b)
        self._release(st, released)
        return entry

    def restore(self, st: SeqState, entry: ResumeEntry, now: float) -> None:
        """Land an offloaded sequence at slot ``st.slot`` and resume it
        where it stopped. The splice and the install are enqueued on the
        current stream before the next decode step, which runs behind them
        on that stream: the resumed sequence reads what it read before
        eviction (frozen pages bitwise their codes, fp pages verbatim), so
        its greedy tokens are those of a sequence that never left."""
        del now
        req, s = st.req, self.slots[st.slot]
        tr = self.tracer
        m = entry.shared_pages
        shared: list[int] = []
        if m:
            t0 = tr.now()
            hit = (self.prefix.lookup(req.prompt, m)
                   if self.prefix is not None else [])
            if len(hit) == m:
                # the shared prefix outlived the offload: splice it back
                # at a reference, the pages decoded against before
                shared = [int(b) for b in hit]
                self.alloc.retain(shared)
                self.counters["prefix_hits"] += 1
                self.counters["prefix_shared_pages"] += m
                tr.complete(self._trk_decode, "prefix_match", t0,
                            rid=req.id, pages=m, cow=False)
            else:
                # its last holder retired meanwhile: rebuild it privately
                shared = self._rebuild_prefix(req, m)
        blocks = shared + self.alloc.alloc(self.sched.blocks_for(req) - m)
        splice_payload(self.pool, entry.payload, blocks[m:], tracer=tr)
        s.rid, s.blocks = req.id, blocks
        s.out, s.logits = list(entry.out), list(entry.logits)
        s.last_token = entry.out[-1]
        s.rng, s.temperature, s.top_k = entry.rng, req.temperature, req.top_k
        self.table[st.slot] = 0
        self.table[st.slot, :len(blocks)] = blocks
        self.lens[st.slot] = entry.n_tokens
        st.length, st.generated = entry.n_tokens, entry.generated
        self.last_attended[st.slot] = self.counters["decode_steps"]
        frozen_idx = entry.payload.frozen_idx
        self._frozen_pages.update(int(blocks[m + j]) for j in frozen_idx)
        # frozen_upto is the longest frozen prefix (installs land in queue
        # order, so in practice the frozen set is one); a quantized shared
        # prefix is installed-frozen and starts it. Pages past it queue
        # for a solve again (their fp rows crossed exact)
        fset = {m + j for j in frozen_idx}
        if m and self.kv_spec is not None:
            fset |= set(range(m))
        upto = 0
        while upto in fset:
            upto += 1
        s.frozen_upto = upto
        self._queue_freeze(st.slot)
        self.counters["restored_seqs"] += 1
        self.counters["restored_pages"] += entry.payload.n_pages
        self.counters["restore_bytes"] += entry.payload.nbytes
        tr.instant(self._trk_decode, "restore", rid=req.id, slot=st.slot,
                   pages=entry.payload.n_pages, tokens=entry.n_tokens)
        if tr.enabled:
            for j, sid in sorted(entry.span_ids.items()):
                tr.async_end(self._trk_freeze, "page_offload", sid,
                             state="restored", rid=req.id, page_pos=j)
        if self.draft is not None:
            # the draft prefills the accepted context (out[-1] has no KV
            # row yet, as at attach); plen stays the original prompt's,
            # since propose reads the pending tokens as out[lens - plen:]
            self.draft.attach(st.slot,
                              tuple(req.prompt) + tuple(entry.out[:-1]),
                              len(blocks))
            self.draft.plen[st.slot] = req.prompt_len
        self._publish_prefixes()

    def _rebuild_prefix(self, req: Request, m: int) -> list[int]:
        """The first ``m`` prompt pages of a restoring sequence whose shared
        prefix was released while it was offloaded, prefilled and (on a
        quantized pool) frozen again privately. The prefill and the solver
        are deterministic, so the pages carry the dead shared pages'
        values."""
        bs = self.block_size
        blocks = self.alloc.alloc(m)
        toks = np.asarray([req.prompt[:m * bs]], np.int32)
        prefill_chunk(self.params, self.cfg, self.pool, toks, blocks, 0,
                      fused=self.attn_impl == "fused")
        if self.kv_spec is not None:
            # installed at once: the restored watermark counts these pages
            # frozen from page 0
            pending = freeze_blocks(self.pool, blocks, self.kv_spec)
            self.counters["host_page_solves"] += pending.host_solves
            self._frozen_pages.update(blocks)
        return blocks

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
        tr = self.tracer
        if tr.enabled or self.roofline_gauges:
            extra = {}
            if self.prefix is not None:
                # pages sharing saves now: each reference past a page's
                # first is a page not allocated
                extra["shared_saved_pages"] = sum(
                    rc - 1 for rc in self.alloc._rc.values() if rc > 1)
            tr.counter(self._trk_decode, "cache", occupancy=round(occ, 6),
                       frozen_pages=frozen, **extra)
            m = modeled_decode_hbm_bytes(self)
            if m is not None:
                self.metrics.stats.gauge("hbm_bytes_per_token").set(
                    m["hbm_bytes_per_token"])
                self.metrics.stats.gauge("t_memory_s").set(m["t_memory_s"])
                tr.counter(self._trk_decode, "roofline",
                           hbm_bytes_per_token=round(
                               m["hbm_bytes_per_token"], 3),
                           t_memory_us=round(m["t_memory_s"] * 1e6, 6))


@dataclasses.dataclass
class _ChunkedPrefill:
    """In-flight chunked prefill: one prompt advancing chunk by chunk so
    the engine can interleave decode steps between chunks."""

    req: Request
    blocks: list
    toks: np.ndarray          # (1, ppad) zero-padded prompt
    nblk: int
    off: int = 0              # tokens already in cache (a shared prefix
    #                           starts it past the spliced pages)
    shared: int = 0           # leading pages spliced from the prefix index
    last_row: object = None   # logits row at prompt position P-1

    @property
    def done(self) -> bool:
        return self.off >= self.toks.shape[1]


class PrefillWorker:
    """The prefill role: prompts -> finished prefills.

    With ``pool=<DecodeWorker>`` it borrows the decode worker's pool and
    allocator (the colocated composition) and emits "splice" payloads of
    block ids. With ``pool=None`` it owns a pool sized for in-flight
    prompts (``2 * max_prompt_blocks + 1`` pages unless ``num_blocks``)
    and emits ``migrate`` payloads through ``step()``, which dispatches at
    most one prefill and harvests it on a later call once the card is
    done. ``migrate="frozen"`` needs ``kv_spec``: the owned pool is then
    quantized (``dispatch_freeze`` solves only there) and every prompt's
    full pages are solved on its side stream behind the prefill. The
    owned pool's whole-prompt prefill reads no earlier page, so it takes
    the gather path and no paged-attention launch."""

    MAX_QUEUE = 64      # prompts routed to one worker and not yet harvested

    def __init__(self, params, cfg, *, pool: DecodeWorker | None = None,
                 device=None, worker_id: int = 0, block_size: int = 16,
                 max_seq_len: int = 256, migrate: str = "fp",
                 kv_spec=None, num_blocks: int | None = None,
                 record_logits: bool = False, metrics=None,
                 prefill_chunk: int | None = None, tracer=None):
        if prefill_chunk is not None and (prefill_chunk < 1 or pool is None):
            raise ValueError("prefill_chunk must be >= 1 token and needs a "
                             "colocated pool (pool=<DecodeWorker>)")
        if migrate not in ("fp", "frozen"):
            raise ValueError(f"a prefill worker migrates fp or frozen pages, "
                             f"not {migrate!r}")
        frozen = migrate == "frozen" and pool is None
        if frozen and kv_spec is None:
            raise ValueError("migrate='frozen' ships codes + codebooks and "
                             "needs a kv_spec (e.g. kmeans_ls@16)")
        self.worker_id = worker_id
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._trk = f"prefill/w{worker_id}"
        self.params, self.cfg = params, cfg
        self.pool = pool
        self.migrate = migrate
        self.kv_spec = kv_spec
        self.block_size = pool.block_size if pool is not None else block_size
        self.record_logits = record_logits
        self.prefill_chunk = prefill_chunk
        self.metrics = metrics if metrics is not None else MetricsCollector()
        self.queue: deque[Request] = deque()
        self._inflight = None   # (req, blocks, logits row, payload)
        # migrate_solves: frozen migration's solves on the owned pool
        self.counters = {"prefills": 0, "prefill_chunks": 0, "queue_peak": 0,
                         "migrated_pages": 0, "migrate_bytes": 0,
                         "migrate_solves": 0}
        if pool is None:
            if device is None:
                raise ValueError("an owned-pool PrefillWorker needs device=")
            self.device = torch.device(device)
            max_prompt_blocks = -(-max_seq_len // block_size)
            self.num_blocks = (num_blocks if num_blocks is not None
                               else 2 * max_prompt_blocks + 1)
            self.own_pool = init_paged_cache(
                cfg, num_blocks=self.num_blocks, block_size=block_size,
                quantized=frozen,
                num_values=kv_spec.num_values if frozen else 16,
                device=self.device)
            self.alloc = BlockAllocator(self.num_blocks)
        else:
            self.device = pool.device
            self.num_blocks = pool.num_blocks

    # ------------------------------------------------------------ routing

    @property
    def load(self) -> int:
        return len(self.queue) + (1 if self._inflight else 0)

    @property
    def busy(self) -> bool:
        return self.load > 0

    def can_accept(self) -> bool:
        return self.load < self.MAX_QUEUE

    def submit(self, req: Request) -> None:
        self.queue.append(req)
        self.counters["queue_peak"] = max(self.counters["queue_peak"],
                                          self.load)

    # ------------------------------------------------------ prefix sharing

    def _match_prefix(self, req: Request) -> list[int]:
        """Longest published-prefix match: retain the matched pages (rc + 1
        each) and return them for splicing into the new sequence's table;
        prefill then starts at the page-aligned offset past them.

        The match is capped one page short of the page holding the
        prompt's last token, so the page feeding the first-token logits
        row is always prefilled privately. A raw match past that cap is
        the copy-on-write event: the tail page exists in the index but is
        prefilled privately instead of shared (``cow_copies``)."""
        pool = self.pool
        if pool.prefix is None:
            return []
        t0 = self.tracer.now()
        cap = (req.prompt_len - 1) // self.block_size
        raw = pool.prefix.lookup(req.prompt, cap + 1)
        shared = [int(b) for b in raw[:cap]]
        if not shared:
            return []
        pool.alloc.retain(shared)
        pool.counters["prefix_hits"] += 1
        pool.counters["prefix_shared_pages"] += len(shared)
        cow = len(raw) > len(shared)
        if cow:
            pool.counters["cow_copies"] += 1
        self.tracer.complete(self._trk, "prefix_match", t0, rid=req.id,
                             pages=len(shared), cow=cow)
        return shared

    # ------------------------------------------------------------ prefill

    def _prompt(self, req: Request) -> np.ndarray:
        """The zero-padded prompt (1, ppad), ppad a whole number of
        pages."""
        ppad = -(-req.prompt_len // self.block_size) * self.block_size
        toks = np.zeros((1, ppad), np.int32)
        toks[0, :req.prompt_len] = req.prompt
        return toks

    def _alloc(self, req: Request, now_fn):
        """Splice any published shared prefix, then allocate the rest of
        the request's worst-case pages in the colocated pool. Returns
        (blocks, zero-padded prompt (1, ppad), prompt pages, shared
        pages)."""
        self.metrics.prefill_start(req.id, now_fn())
        shared = self._match_prefix(req)
        blocks = shared + self.pool.alloc.alloc(
            self.pool.sched.blocks_for(req) - len(shared))
        toks = self._prompt(req)
        return blocks, toks, toks.shape[1] // self.block_size, len(shared)

    def _whole(self, pool, toks: np.ndarray, blocks):
        """Whole-prompt prefill of ``toks`` (1, ppad) into ``pool`` over
        ``blocks`` (the gather read path). Returns logits (1, ppad, V)."""
        views = with_tables(pool, np.asarray([blocks], np.int32),
                            np.zeros((1,), np.int32))
        logits, _ = models.prefill(
            self.params, self.cfg,
            # lint: sync(pageable copy of the prompt's ids; ROADMAP A2)
            {"tokens": torch.as_tensor(toks).to(pool.device)}, views)
        return logits

    def _chunk(self, toks: np.ndarray, blocks, off: int):
        """``prefill_chunk`` into the colocated pool (through the kernel
        when fused). Returns logits (1, C, V)."""
        return prefill_chunk(self.params, self.cfg, self.pool.pool, toks,
                             blocks, off,
                             fused=self.pool.attn_impl == "fused")

    def _finish(self, req: Request, payload, last,
                now_fn) -> FinishedPrefill:
        last = last.cpu().numpy()  # lint: sync(first-token sampling)
        now = now_fn()                        # TTFT includes prefill time
        rng = req.make_rng()
        tok = sample_token(last, temperature=req.temperature,
                           top_k=req.top_k, rng=rng)
        self.metrics.first_token(req.id, now)
        self.counters["prefills"] += 1
        return FinishedPrefill(
            req=req, first_token=tok, payload=payload, rng=rng,
            last_logits=last if self.record_logits else None,
            worker_id=self.worker_id)

    def run_inline(self, req: Request, now_fn) -> FinishedPrefill:
        """Synchronous whole-prompt prefill into the colocated pool (the
        gather read path). Past a spliced shared prefix it is one chunk
        from the page-aligned offset (explicit positions; through the
        kernel when fused)."""
        tr = self.tracer
        t0 = tr.now()
        tr.async_begin(self._trk, "prefill", req.id, rid=req.id,
                       prompt_len=req.prompt_len)
        blocks, toks, nblk, shared = self._alloc(req, now_fn)
        off = shared * self.block_size
        if off:
            logits = self._chunk(toks[:, off:], blocks[:nblk], off)
        else:
            logits = self._whole(self.pool.pool, toks, blocks[:nblk])
        tr.complete(self._trk, "dispatch", t0, rid=req.id,
                    prompt_len=req.prompt_len, pages=nblk, shared=shared)
        t0 = tr.now()
        fin = self._finish(
            req, splice_of(blocks, req.prompt_len, self.block_size, shared),
            logits[0, req.prompt_len - 1 - off], now_fn)
        tr.complete(self._trk, "harvest", t0, rid=req.id)
        tr.async_end(self._trk, "prefill", req.id, rid=req.id)
        return fin

    # ------------------------------------------------ owned pool (async)

    def _dispatch(self, req: Request, now_fn) -> None:
        """Enqueue one prompt's prefill into the owned pool and the
        extraction of its pages (a frozen payload's solve on the pool's
        side stream, behind the prefill); returns without waiting for the
        card."""
        tr = self.tracer
        t0 = tr.now()
        self.metrics.prefill_start(req.id, now_fn())
        # the async span from dispatch to harvest: the card's lifetime of
        # this prompt's prefill (and any solve behind it)
        tr.async_begin(self._trk, "prefill", req.id, rid=req.id,
                       prompt_len=req.prompt_len)
        toks = self._prompt(req)
        blocks = self.alloc.alloc(toks.shape[1] // self.block_size)
        logits = self._whole(self.own_pool, toks, blocks)
        payload = extract_pages(self.own_pool, blocks, req.prompt_len,
                                block_size=self.block_size,
                                mode=self.migrate, spec=self.kv_spec,
                                tracer=tr)
        if payload.frozen is not None:
            self.counters["migrate_solves"] += 1
        self._inflight = (req, blocks, logits[0, req.prompt_len - 1],
                          payload)
        tr.complete(self._trk, "dispatch", t0, rid=req.id,
                    prompt_len=req.prompt_len, pages=len(blocks))

    def _harvest(self, now_fn) -> FinishedPrefill:
        """The finished prefill: sample the first token, stage the
        payload to host memory, free the owned pool's blocks."""
        tr = self.tracer
        t0 = tr.now()
        req, blocks, last, payload = self._inflight
        self._inflight = None
        fin = self._finish(req, payload, last, now_fn)
        t_host = tr.now()
        payload.to_host()           # gated on is_ready: the card is done
        tr.complete("transfer", "to_host", t_host, rid=req.id,
                    mode=payload.mode, bytes=payload.nbytes,
                    fp_equiv_bytes=payload.fp_equiv_bytes,
                    pages=payload.n_pages)
        self.alloc.free(blocks)     # the pages left as a host payload (the
        #                             solve reading them has ended too)
        self.counters["migrated_pages"] += payload.n_pages
        self.counters["migrate_bytes"] += payload.nbytes
        tr.complete(self._trk, "harvest", t0, rid=req.id,
                    bytes=payload.nbytes)
        tr.async_end(self._trk, "prefill", req.id, rid=req.id)
        return fin

    def step(self, now_fn, block: bool = False) -> list[FinishedPrefill]:
        """Advance the owned-pool worker: dispatch the queue head if idle
        (and its prompt pages fit), harvest the in-flight prefill once the
        card finished it (at once when ``block``, waiting for the card).
        Returns 0 or 1 finished prefills."""
        if self.pool is not None:
            raise ValueError("step() drives an owned-pool worker; a "
                             "colocated one runs run_inline or chunks")
        if self._inflight is None and self.queue:
            nblk = -(-self.queue[0].prompt_len // self.block_size)
            if nblk <= self.alloc.num_free:
                self._dispatch(self.queue.popleft(), now_fn)
        # harvest only once the prefill, the gathers and any solve landed:
        # to_host() on work still in flight would stall the caller's decode
        # loop
        if self._inflight is not None and (block
                                           or self._inflight[3].is_ready()):
            return [self._harvest(now_fn)]
        return []

    # ---------------------------------------------------------- chunked

    def start_chunked(self, req: Request, now_fn) -> _ChunkedPrefill:
        """Open a chunked prefill: allocate the request's worst-case pages
        and return the chunk cursor; the engine then calls
        ``advance_chunk`` once per iteration, between decode steps."""
        if not self.prefill_chunk:
            raise ValueError("start_chunked needs prefill_chunk")
        self.tracer.async_begin(self._trk, "prefill", req.id, rid=req.id,
                                prompt_len=req.prompt_len)
        blocks, toks, nblk, shared = self._alloc(req, now_fn)
        # a matched prefix starts the chunk cursor past the spliced pages:
        # those tokens are already in cache
        return _ChunkedPrefill(req=req, blocks=blocks, toks=toks, nblk=nblk,
                               off=shared * self.block_size, shared=shared)

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
        logits = self._chunk(state.toks[:, off:off + C],
                             state.blocks[:state.nblk], off)
        if off <= P - 1 < off + C:
            state.last_row = logits[0, P - 1 - off]
        state.off = off + C
        self.counters["prefill_chunks"] += 1
        pool = self.pool
        if tr.enabled or pool.roofline_gauges:
            m = modeled_prefill_hbm_bytes(
                pool._pb, state.blocks, pool._frozen_pages,
                block_size=self.block_size, off=off, chunk=C,
                fused=pool.attn_impl == "fused")
            self.metrics.stats.gauge("prefill_hbm_bytes_per_token").set(
                m["hbm_bytes_per_token"])
            tr.counter(self._trk, "roofline",
                       prefill_hbm_bytes_per_token=round(
                           m["hbm_bytes_per_token"], 3))
        tr.complete(self._trk, "prefill_chunk", t0, rid=req.id, off=off,
                    chunk=C)
        if not state.done:
            return None
        fin = self._finish(
            req, splice_of(state.blocks, P, self.block_size, state.shared),
            state.last_row, now_fn)
        tr.async_end(self._trk, "prefill", req.id, rid=req.id)
        return fin
