"""Overload survival: tiered host offload of a victim's pages,
preempt-and-requeue, and SLO-aware admission (port of
``repro/serving/overload.py``).

Three mechanisms let a full pool degrade gracefully instead of rejecting
at the admission door:

  tiered paging    Under pressure a whole victim sequence's pages demote
      to a ``HostPageStore`` as a "resident" payload
      (``transfer.extract_resident_pages``): installed-frozen pages cross
      as their packed 4-bit codes and codebooks (3.97x fewer bytes than
      fp for bf16 pages at 16 values), the rest fp. The restore runs at
      re-admission, before the decode step that needs the pages, and the
      splice and install are enqueued on the stream that step runs on, so
      a restored sequence is greedy-token-identical to one that never
      left.

  preempt-and-requeue    ``DecodeWorker.preempt`` evicts a victim at a
      step boundary (the teardown of a finished sequence, so every pool
      invariant holds), and preempted requests re-admit ahead of FCFS.
      ``choose_resume`` picks restore (move the payload back: exact) or
      recompute (re-prefill prompt plus emitted tokens: cheaper when
      little was frozen, but value-exact only on fp greedy runs, so
      quantized or sampled runs always restore).

  SLO-aware admission    ``SLOAdmission`` reads the windowed inter-token
      p99 from the metrics registry (log-histogram count deltas) and the
      pool occupancy, and sheds or defers best_effort requests; latency
      requests meet only the hard queue and pool doors. Deferred requests
      wait in the ``OverloadManager`` and retry when occupancy recedes.

``OverloadManager`` composes the three for an engine: its run loop calls
``retry_deferred`` and ``try_restore`` (restored sequences re-enter ahead
of any FCFS admission) and ``maybe_preempt`` (evict a best_effort victim
when a latency request is blocked on capacity) once an iteration. Every
decision is host-side and deterministic.
"""
from __future__ import annotations

import dataclasses
from collections import deque

from .transfer import PagePayload


@dataclasses.dataclass
class ResumeEntry:
    """What resumes a preempted sequence where it stopped: the request,
    its emitted tokens (``out``; the last has no KV row yet, as at
    attach), the sampler state and the demoted pages. ``n_tokens`` is the
    KV length at eviction (prompt_len + generated - 1 at a step
    boundary). ``shared_pages`` counts the leading pages the victim shared
    with other live tables: it dropped a reference to them instead of
    demoting them, and the restore splices them back from the prefix index
    (or rebuilds them if their last reference died meanwhile)."""

    req: object
    out: list
    generated: int
    n_tokens: int
    rng: object = None
    logits: list = dataclasses.field(default_factory=list)
    payload: PagePayload | None = None         # None: the recompute path
    shared_pages: int = 0
    # page position in the payload -> its open ``page_offload`` span id
    # (traced runs), closed "restored" by the restore
    span_ids: dict = dataclasses.field(default_factory=dict)


class HostPageStore:
    """The host-memory tier: demoted sequences' staged payloads by request
    id. ``nbytes`` is the footprint of everything demoted now."""

    def __init__(self):
        self._entries: dict[int, ResumeEntry] = {}

    def put(self, entry: ResumeEntry) -> None:
        rid = entry.req.id
        if rid in self._entries:
            raise ValueError(f"request {rid} is demoted already")
        if entry.payload is None or not entry.payload.staged:
            raise ValueError(f"request {rid}: the host tier holds staged "
                             f"payloads only")
        self._entries[rid] = entry

    def pop(self, rid: int) -> ResumeEntry:
        return self._entries.pop(rid)

    def release(self, rid: int) -> ResumeEntry | None:
        """Reclaim a retired request's entry (it finished or was cancelled
        while demoted); absent is fine, unlike ``pop``."""
        return self._entries.pop(rid, None)

    def __contains__(self, rid: int) -> bool:
        return rid in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return sum(e.payload.nbytes for e in self._entries.values())

    @property
    def pages(self) -> int:
        return sum(e.payload.n_pages for e in self._entries.values())

    def entries(self) -> list[ResumeEntry]:
        return list(self._entries.values())


def choose_resume(*, frozen_pages: int, total_pages: int, restore_bytes: int,
                  fp_equiv_bytes: int, exact_required: bool) -> str:
    """Restore or recompute a preemption victim.

    Restore moves ``restore_bytes`` back from the host tier; recompute
    re-prefills the whole context, writing ``fp_equiv_bytes`` of KV at
    full width plus the prefill's work. Restore wins when the payload is
    well compressed (enough pages frozen). ``exact_required`` forces
    restore: a recompute re-prefills through exact fp where the first
    life served quantized reconstructions, and a sampled request's
    Generator cannot be rewound. ``frozen_pages`` is the reference's
    argument; only the bytes decide."""
    if exact_required:
        return "restore"
    if total_pages == 0:
        return "recompute"          # nothing to move
    # compressed below 60% of a full fp rewrite: moving it back beats the
    # re-prefill (whose compute the overloaded card does not have)
    if restore_bytes <= 0.6 * fp_equiv_bytes:
        return "restore"
    return "recompute"


class SLOAdmission:
    """Shed/defer policy over the metrics registry's live signals: the
    windowed inter-token p99 (``itl_s`` bucket-count deltas between
    snapshots) and the pool occupancy. Latency requests always pass;
    best_effort ones are shed while the p99 breaches ``itl_slo_s`` and
    deferred while the pool is nearly full. Deferred requests re-admit
    once occupancy falls to ``occ_resume`` (or the worker idles), so the
    door does not flap at the threshold."""

    def __init__(self, metrics, *, itl_slo_s: float | None = None,
                 occ_defer: float = 0.95, occ_resume: float = 0.80,
                 window: int = 128, min_samples: int = 16):
        if not 0.0 < occ_resume <= occ_defer <= 1.0:
            raise ValueError(f"want 0 < occ_resume ({occ_resume}) <= "
                             f"occ_defer ({occ_defer}) <= 1")
        self.metrics = metrics
        self.itl_slo_s = itl_slo_s
        self.occ_defer = occ_defer
        self.occ_resume = occ_resume
        self.window = window
        self.min_samples = min_samples
        self._snap = None            # histogram state at the window start
        self._last = None            # the last closed window's p99

    def windowed_itl_p99(self) -> float | None:
        """p99 of the inter-token gaps over the current window; until
        ``min_samples`` gaps landed in it, the last closed window's (None
        before the first)."""
        if "itl_s" not in self.metrics.stats:
            return None
        h = self.metrics.stats.histogram("itl_s")
        if self._snap is None:
            # the first window starts empty, so gaps observed before the
            # policy's first decision count
            self._snap = {"counts": [0] * len(h.counts), "underflow": 0,
                          "overflow": 0, "n": 0}
        d = h.delta(self._snap)
        if d["n"] >= self.window:
            # roll the window forward; answer over the one closing
            self._last = h.percentile(99, **d)
            self._snap = h.state()
            return self._last
        if d["n"] >= self.min_samples:
            return h.percentile(99, **d)
        return self._last

    def decide(self, req, *, occupancy: float) -> str:
        """'admit', 'shed' or 'defer' for an arriving request."""
        if getattr(req, "priority", "latency") != "best_effort":
            return "admit"
        if self.itl_slo_s is not None:
            p99 = self.windowed_itl_p99()
            if p99 is not None and p99 > self.itl_slo_s:
                return "shed"
        if occupancy >= self.occ_defer:
            return "defer"
        return "admit"

    def may_resume(self, *, occupancy: float, idle: bool) -> bool:
        """Whether deferred requests may re-admit (the hysteresis band)."""
        return idle or occupancy <= self.occ_resume


class OverloadManager:
    """An engine's overload state: the host tier, the restore queue, the
    deferred queue and the preemption trigger. Its methods take the decode
    worker they act on, so the disaggregated engine shares one manager
    across its decode workers (a payload may restore onto another worker
    than the one it left). ``router`` is the disaggregated engine's: its
    queues take recompute requeues and deferred retries there."""

    def __init__(self, *, offload_pages: bool = True, policy=None,
                 router=None):
        self.offload_pages = offload_pages
        self.policy = policy
        self.router = router
        self.store = HostPageStore()
        self.resume: deque[ResumeEntry] = deque()
        self.deferred: deque = deque()

    @property
    def has_work(self) -> bool:
        return bool(self.resume or self.deferred or len(self.store))

    def _queues(self, worker):
        """The admission queues of this composition: the router's when
        disaggregated, else the worker's scheduler's."""
        return self.router if self.router is not None else worker.sched

    # ------------------------------------------------------------ restore

    def try_restore(self, worker, now_fn) -> int:
        """Restore resume-queue entries, head first, into the worker's free
        capacity; stops at the first that does not fit (a later, smaller
        entry must not starve the head). Runs before FCFS admission, so a
        preempted sequence re-enters ahead of every queued arrival."""
        n = 0
        while self.resume:
            entry = self.resume[0]
            req = entry.req
            need = worker.sched.blocks_for(req)
            if not worker.sched._free_slots or need > worker.alloc.num_free:
                break
            if getattr(req, "priority", "latency") == "best_effort":
                # a best_effort victim must not take back the capacity its
                # eviction freed for a blocked latency head: it restores
                # only when slots and pages suffice for both
                head = self._queue_head(worker)
                if (head is not None
                        and getattr(head, "priority", "latency") == "latency"
                        and (len(worker.sched._free_slots) < 2
                             or worker.alloc.num_free
                             < need + worker.sched.blocks_for(head))):
                    break
            self.resume.popleft()
            self.store.pop(req.id)
            st = worker.sched.admit_direct(req)
            worker.restore(st, entry, now_fn())
            n += 1
        return n

    def retry_deferred(self, worker) -> int:
        """Move deferred best_effort requests back to the waiting queue
        once pressure recedes (the policy's ``occ_resume``, or an idle
        worker). Deferral bought them a later place in line, not a
        priority; their arrival was metered when they were deferred, and
        the queue-depth door still holds."""
        if not self.deferred or self.policy is None:
            return 0
        occ = 1.0 - worker.alloc.num_free / (worker.num_blocks - 1)
        if not self.policy.may_resume(occupancy=occ,
                                      idle=not worker.sched.active):
            return 0
        q = self._queues(worker)
        n = 0
        while self.deferred and len(q.waiting) < q.max_queue:
            q.waiting.append(self.deferred.popleft())
            n += 1
        return n

    def retire(self, rid: int) -> ResumeEntry | None:
        """Release a request's host-tier entry and resume-queue place when
        it retires (finished, cancelled, or the run ended while it was
        demoted). Returns the entry, whose ``out`` is everything the
        request emitted, or None if it was not demoted."""
        entry = self.store.release(rid)
        if entry is not None:
            self.resume = deque(e for e in self.resume if e.req.id != rid)
        return entry

    # ------------------------------------------------------------ preempt

    def _queue_head(self, worker):
        """The first request in the admission queues: staged prefills
        (disaggregated) before recompute requeues before FCFS."""
        if self.router is not None and self.router.staged:
            return self.router.staged[0].req
        q = self._queues(worker)
        if q.preempted:
            return q.preempted[0]
        if q.waiting:
            return q.waiting[0]
        return None

    def _head(self, worker):
        """The request first in line for this worker's capacity: resume
        entries before the admission queues."""
        if self.resume:
            return self.resume[0].req
        return self._queue_head(worker)

    def pick_victim(self, worker):
        """A best_effort sequence to evict for a latency head blocked on
        slots or pages, or None. Coldest first: least recently attended
        (the decode step at which it last emitted, seeded at attach and
        restore), then the largest frozen share (cheapest to demote), then
        the slot. Only across tiers, and only when evicting best_effort
        sequences could unblock the head."""
        head = self._head(worker)
        if head is None or getattr(head, "priority", "latency") != "latency":
            return None
        need = worker.sched.blocks_for(head)
        slot_blocked = not worker.sched._free_slots
        page_blocked = need > worker.alloc.num_free
        if not (slot_blocked or page_blocked):
            return None
        # a sequence still chunking its prompt holds a slot and pages but
        # no output: it is not in last_attended until it attaches
        victims = [st for st in worker.sched.active.values()
                   if getattr(st.req, "priority", "latency") == "best_effort"
                   and st.slot in worker.last_attended]
        if not victims:
            return None
        if page_blocked:
            reclaimable = sum(len(worker.slots[st.slot].blocks)
                              for st in victims)
            if worker.alloc.num_free + reclaimable < need:
                return None          # eviction cannot unblock: no thrash

        def rank(st):
            s = worker.slots[st.slot]
            frozen = sum(1 for b in s.blocks if b in worker._frozen_pages)
            return (worker.last_attended[st.slot],
                    -frozen / max(len(s.blocks), 1), st.slot)

        return min(victims, key=rank)

    def maybe_preempt(self, worker, now_fn) -> bool:
        """Evict at most one victim a call (pressure ramps instead of
        evicting many at once). The cost model picks offload-and-restore or
        drop-and-recompute; without the host tier, recompute is the only
        way back."""
        st = self.pick_victim(worker)
        if st is None:
            return False
        s = worker.slots[st.slot]
        # shared prefix pages neither demote nor restore (they drop a
        # reference and splice back from the index): the cost model sees
        # only the owned suffix on both sides
        sh = worker.shared_prefix_pages(st.slot)
        full = int(worker.lens[st.slot]) // worker.block_size
        frozen = sum(1 for b in s.blocks[sh:full]
                     if b in worker._frozen_pages)
        n_pages = -(-int(worker.lens[st.slot]) // worker.block_size) - sh
        pb = worker._pb
        est = frozen * pb["frozen"] + (n_pages - frozen) * pb["fp"]
        exact = worker.kv_spec is not None or st.req.temperature > 0.0
        mode = "recompute"
        if self.offload_pages:
            mode = choose_resume(
                frozen_pages=frozen, total_pages=n_pages, restore_bytes=est,
                fp_equiv_bytes=n_pages * pb["fp"], exact_required=exact)
        entry = worker.preempt(st, mode, now_fn())
        if mode == "restore":
            self.store.put(entry)
            self.resume.append(entry)
        else:
            # a fresh request whose prompt is the original plus everything
            # emitted (the worker merges the prefix back at finish), ahead
            # of FCFS; disaggregated, it re-prefills on a prefill worker
            self._queues(worker).preempted.append(entry.req)
        return True
