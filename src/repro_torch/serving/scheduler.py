"""Continuous-batching scheduler: iteration-level batching with admission
control, and the disaggregated engine's router (port of
``repro/serving/scheduler.py``).

Pure decision logic over a free-page count: no model, no tensors.
Admission is conservative: a request is scheduled only when its worst-case
page need, ceil((prompt + max_new + lookahead) / block_size), fits, so a
scheduled request can never deadlock the pool mid-decode. Requests
evicted by preemption (``serving.overload``) wait in ``preempted`` and
re-admit ahead of FCFS on both the scheduler and the router. ``lookahead``
is the speculative verify window's optimistic rows; a prefix-cache probe
may discount the pages a prompt will share instead of allocating.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.obs.trace import NULL_TRACER


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request. temperature 0 is greedy argmax; a positive
    temperature samples with a per-request numpy Generator seeded from
    ``seed`` (else the id), so a trace replays token-identically.
    ``priority`` is the SLO tier: "latency" requests are protected by
    admission control and may preempt; "best_effort" ones are shed or
    deferred under overload, and are the preemption victims."""

    id: int
    prompt: tuple          # token ids
    max_new_tokens: int
    arrival_time: float = 0.0
    temperature: float = 0.0
    top_k: int = 0
    seed: int | None = None
    priority: str = "latency"

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    def make_rng(self) -> np.random.Generator:
        return np.random.default_rng(self.id if self.seed is None
                                     else self.seed)


@dataclasses.dataclass
class SeqState:
    """Scheduler-side state of an admitted sequence."""

    req: Request
    slot: int
    length: int            # tokens with KV in cache
    generated: int = 0

    @property
    def done(self) -> bool:
        return self.generated >= self.req.max_new_tokens


class ContinuousBatchingScheduler:
    def __init__(self, *, max_slots: int, block_size: int,
                 max_queue: int = 256, lookahead: int = 0):
        self.max_slots = max_slots
        self.block_size = block_size
        self.max_queue = max_queue
        # speculative decoding writes its verify window optimistically: up
        # to `lookahead` rows past the final accepted length need pages
        # (rolled-back rows are rewritten, never served)
        self.lookahead = lookahead
        self.waiting: deque[Request] = deque()
        # requests evicted mid-decode by preemption: they waited their turn
        # once, so they re-admit ahead of every queued arrival
        self.preempted: deque[Request] = deque()
        self.active: dict[int, SeqState] = {}       # slot -> state
        self._free_slots = list(range(max_slots - 1, -1, -1))
        self.rejected: list[int] = []

    def blocks_for(self, req: Request) -> int:
        total = req.prompt_len + req.max_new_tokens + self.lookahead
        return -(-total // self.block_size)

    def submit(self, req: Request) -> bool:
        """Admission control at the queue door; False = rejected (429)."""
        if len(self.waiting) >= self.max_queue:
            self.rejected.append(req.id)
            return False
        self.waiting.append(req)
        return True

    def schedule(self, free_blocks: int, discount=None) -> list[SeqState]:
        """Admit FCFS from the queue into free slots while pages last
        (head-of-line blocking keeps the schedule deterministic);
        preempted requests drain first.

        ``discount(req)`` (optional) gives the pages of the request's
        prompt already resident and shareable (the prefix-cache probe):
        admission charges worst case minus those, since its prefill splices
        them instead of allocating."""
        admitted = []
        while (self.preempted or self.waiting) and self._free_slots:
            q = self.preempted if self.preempted else self.waiting
            need = self.blocks_for(q[0])
            if discount is not None:
                need = max(need - discount(q[0]), 0)
            if need > free_blocks:
                break
            req = q.popleft()
            slot = self._free_slots.pop()
            st = SeqState(req=req, slot=slot, length=0)
            self.active[slot] = st
            admitted.append(st)
            free_blocks -= need
        return admitted

    def admit_direct(self, req: Request) -> SeqState | None:
        """Bind ``req`` to a free slot now, bypassing the waiting queue:
        the disaggregated import path, whose request was queued by the
        router and prefilled on a prefill worker already. None when no
        slot is free. Page accounting stays with the caller, which checks
        the worker's free pages before offering."""
        if not self._free_slots:
            return None
        slot = self._free_slots.pop()
        st = SeqState(req=req, slot=slot, length=0)
        self.active[slot] = st
        return st

    def stage(self, st: SeqState) -> None:
        """Park an admitted sequence out of the decode batch (slot and
        pages stay reserved) while its prompt prefills in chunks."""
        del self.active[st.slot]

    def activate(self, st: SeqState) -> None:
        """Re-enter a ``stage``d sequence into the decode batch."""
        if st.slot in self.active:
            raise ValueError(f"slot {st.slot} already active")
        self.active[st.slot] = st

    def release(self, st: SeqState) -> None:
        del self.active[st.slot]
        self._free_slots.append(st.slot)
        self._free_slots.sort(reverse=True)   # deterministic reuse order

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.preempted or self.active)

    def active_slots(self) -> list[int]:
        return sorted(self.active)


class DisaggRouter:
    """The disaggregated engine's global router: one queue in front of N
    prefill workers and M decode workers. Pure decision logic: workers are
    duck-typed (prefill workers expose ``worker_id``, ``load``,
    ``can_accept()`` and ``submit``; decode workers ``worker_id``,
    ``can_accept(req)`` and ``free_slots``), so the policy is testable
    with fakes. Requests flow

        submit -> waiting -> [prefill worker] -> stage -> [decode worker]

    ``route_prefill`` assigns FCFS to the least-loaded prefill worker
    (ties to the lowest index, so the schedule is deterministic);
    ``route_decode`` places staged prefills FCFS onto the decode worker
    with the most free slots that can hold the request's worst-case pages.
    A staged head that fits nowhere waits (head-of-line): its pages are
    computed and on the host already, so holding it costs no device
    memory, and FCFS keeps it starvation-free.

    ``staging_depth`` bounds the prefills in flight past the waiting
    queue (on a prefill worker or staged): when decode capacity stalls,
    ``route_prefill`` stops feeding the prefill workers instead of growing
    ``staged`` without bound, and the waiting queue's ``max_queue`` door
    rejects. None is unbounded. ``preempted`` holds requests a
    recompute-path preemption sends back to re-prefill: they go to a
    prefill worker ahead of ``waiting``."""

    def __init__(self, *, max_queue: int = 256,
                 staging_depth: int | None = None, tracer=None):
        if staging_depth is not None and staging_depth < 1:
            raise ValueError(f"staging_depth {staging_depth}: want >= 1 or "
                             f"None")
        self.max_queue = max_queue
        self.staging_depth = staging_depth
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.waiting: deque[Request] = deque()
        self.preempted: deque[Request] = deque()
        self.staged: deque = deque()           # FinishedPrefill artifacts
        self.rejected: list[int] = []

    def submit(self, req: Request) -> bool:
        """Queue-depth admission control at the global door (False = 429)."""
        if len(self.waiting) >= self.max_queue:
            self.rejected.append(req.id)
            self.tracer.instant("router", "reject", rid=req.id,
                                reason="queue_full")
            return False
        self.waiting.append(req)
        self.tracer.instant("router", "admit", rid=req.id,
                            queued=len(self.waiting))
        return True

    def route_prefill(self, workers) -> list:
        """Assign waiting requests to prefill workers; returns the
        (worker, request) assignments made. With a ``staging_depth`` the
        assignments stop once prefill-worker load plus staged artifacts
        reach it."""
        out = []
        inflight = (sum(w.load for w in workers) + len(self.staged)
                    if self.staging_depth is not None else 0)
        while self.waiting or self.preempted:
            if (self.staging_depth is not None
                    and inflight >= self.staging_depth):
                break
            ranked = sorted((w for w in workers if w.can_accept()),
                            key=lambda w: (w.load, w.worker_id))
            if not ranked:
                break
            q = self.preempted if self.preempted else self.waiting
            req = q.popleft()
            ranked[0].submit(req)
            inflight += 1
            self.tracer.instant("router", "route_prefill", rid=req.id,
                                worker=ranked[0].worker_id,
                                load=ranked[0].load)
            out.append((ranked[0], req))
        return out

    def stage(self, finished) -> None:
        """Park a finished prefill until a decode worker can take it."""
        self.staged.append(finished)
        self.tracer.instant("router", "stage", rid=finished.req.id,
                            staged=len(self.staged))

    def route_decode(self, workers, place=None) -> list:
        """Offer staged prefills FCFS to decode workers. ``place(worker,
        finished)`` runs at once for each placement, so the next one sees
        the capacity (slots, pages) this one consumed. Returns the
        placements made."""
        out = []
        while self.staged:
            req = self.staged[0].req
            ranked = sorted((w for w in workers if w.can_accept(req)),
                            key=lambda w: (-w.free_slots, w.worker_id))
            if not ranked:
                break
            fin = self.staged.popleft()
            self.tracer.instant("router", "route_decode", rid=fin.req.id,
                                worker=ranked[0].worker_id,
                                free_slots=ranked[0].free_slots)
            if place is not None:
                place(ranked[0], fin)
            out.append((ranked[0], fin))
        return out

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.preempted or self.staged)


def derive_seed(seed: int | None, i: int) -> int | None:
    """Per-request sampling seed from one trace-level seed."""
    return None if seed is None else seed * 100003 + i


def make_requests(prompts, max_new_tokens: int, *, temperature: float = 0.0,
                  top_k: int = 0, seed: int | None = None,
                  priority: str = "latency") -> list[Request]:
    """Requests for a batch of prompts, all arriving at t=0."""
    return [Request(id=i, prompt=tuple(p), max_new_tokens=max_new_tokens,
                    temperature=temperature, top_k=top_k,
                    seed=derive_seed(seed, i), priority=priority)
            for i, p in enumerate(prompts)]


def poisson_trace(n: int, rate: float, *, vocab: int, prompt_len: int,
                  max_new_tokens: int, seed: int = 0,
                  temperature: float = 0.0, top_k: int = 0,
                  best_effort_frac: float = 0.0,
                  shared_prefix_len: int = 0) -> list[Request]:
    """n requests with exp(1/rate) inter-arrival gaps (rate in req/s);
    the same requests as the reference's trace for one seed.
    ``best_effort_frac`` marks that (seed-derived) fraction of the
    requests "best_effort". ``shared_prefix_len`` starts every prompt with one seed-derived common
    token run (a shared system prompt): the traffic the prefix cache
    deduplicates."""
    if not 0 <= shared_prefix_len <= prompt_len:
        raise ValueError(f"shared_prefix_len {shared_prefix_len} outside "
                         f"[0, prompt_len {prompt_len}]")
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1.0 / rate, n))
    tiers = rng.random(n) < best_effort_frac
    common = tuple(int(x) for x in rng.integers(0, vocab, shared_prefix_len))
    uniq = prompt_len - shared_prefix_len
    return [Request(id=i,
                    prompt=common + tuple(int(x) for x in
                                          rng.integers(0, vocab, uniq)),
                    max_new_tokens=max_new_tokens,
                    arrival_time=float(t[i]),
                    temperature=temperature, top_k=top_k,
                    seed=derive_seed(seed, i),
                    priority="best_effort" if tiers[i] else "latency")
            for i in range(n)]
