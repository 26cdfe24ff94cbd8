"""Continuous-batching scheduler: iteration-level batching with admission
control (port of ``repro/serving/scheduler.py``; the disaggregated router
and the preemption queue come in later slices).

Pure decision logic over a free-page count: no model, no tensors.
Admission is conservative: a request is scheduled only when its worst-case
page need, ceil((prompt + max_new) / block_size), fits, so a scheduled
request can never deadlock the pool mid-decode.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request. temperature 0 is greedy argmax; a positive
    temperature samples with a per-request numpy Generator seeded from
    ``seed`` (else the id), so a trace replays token-identically."""

    id: int
    prompt: tuple          # token ids
    max_new_tokens: int
    arrival_time: float = 0.0
    temperature: float = 0.0
    top_k: int = 0
    seed: int | None = None

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
                 max_queue: int = 256):
        self.max_slots = max_slots
        self.block_size = block_size
        self.max_queue = max_queue
        self.waiting: deque[Request] = deque()
        self.active: dict[int, SeqState] = {}       # slot -> state
        self._free_slots = list(range(max_slots - 1, -1, -1))
        self.rejected: list[int] = []

    def blocks_for(self, req: Request) -> int:
        total = req.prompt_len + req.max_new_tokens
        return -(-total // self.block_size)

    def submit(self, req: Request) -> bool:
        """Admission control at the queue door; False = rejected (429)."""
        if len(self.waiting) >= self.max_queue:
            self.rejected.append(req.id)
            return False
        self.waiting.append(req)
        return True

    def schedule(self, free_blocks: int) -> list[SeqState]:
        """Admit FCFS from the queue into free slots while pages last
        (head-of-line blocking keeps the schedule deterministic)."""
        admitted = []
        while self.waiting and self._free_slots:
            need = self.blocks_for(self.waiting[0])
            if need > free_blocks:
                break
            req = self.waiting.popleft()
            slot = self._free_slots.pop()
            st = SeqState(req=req, slot=slot, length=0)
            self.active[slot] = st
            admitted.append(st)
            free_blocks -= need
        return admitted

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
        return bool(self.waiting or self.active)

    def active_slots(self) -> list[int]:
        return sorted(self.active)


def derive_seed(seed: int | None, i: int) -> int | None:
    """Per-request sampling seed from one trace-level seed."""
    return None if seed is None else seed * 100003 + i


def make_requests(prompts, max_new_tokens: int, *, temperature: float = 0.0,
                  top_k: int = 0, seed: int | None = None) -> list[Request]:
    """Requests for a batch of prompts, all arriving at t=0."""
    return [Request(id=i, prompt=tuple(p), max_new_tokens=max_new_tokens,
                    temperature=temperature, top_k=top_k,
                    seed=derive_seed(seed, i))
            for i, p in enumerate(prompts)]


def poisson_trace(n: int, rate: float, *, vocab: int, prompt_len: int,
                  max_new_tokens: int, seed: int = 0,
                  temperature: float = 0.0, top_k: int = 0) -> list[Request]:
    """n requests with exp(1/rate) inter-arrival gaps (rate in req/s);
    the same requests as the reference's trace for one seed."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1.0 / rate, n))
    rng.random(n)   # the reference draws each request's SLO tier here
    return [Request(id=i,
                    prompt=tuple(int(x) for x in
                                 rng.integers(0, vocab, prompt_len)),
                    max_new_tokens=max_new_tokens,
                    arrival_time=float(t[i]),
                    temperature=temperature, top_k=top_k,
                    seed=derive_seed(seed, i))
            for i in range(n)]
