"""KV page handoff between serving workers, prefill to decode, and a
live sequence's demotion to host memory under overload (port of
``repro/serving/transfer.py``).

A finished prefill's pages leave the prefill worker's pool as a
``PagePayload`` and land in a decode worker's pool through
``splice_payload``: the decode worker allocates fresh block ids, the
payload's pages are scattered into its pool at those ids, and the
sequence's block-table row points at them (a page-table splice, not a pool
copy).

Four modes:

  "splice"   Colocated no-op: the prefill wrote straight into the decode
             worker's (shared) pool, so the payload carries block ids and
             no tensors. Zero bytes move.

  "fp"       Every written row crosses at full width: full pages whole,
             the trailing partial page only its valid rows. What
             disaggregated serving without codebook compression pays a
             handoff.

  "frozen"   Full pages are solved by ``dispatch_freeze`` on the source
             (prefill) pool, on its side stream behind the prefill, and
             cross as packed 4-bit codes + one codebook per page, layer
             and k/v (3.97x fewer bytes than fp for bf16 pages at 16
             values); they land through ``install_freeze``, which writes
             codes, codebooks, the reconstruction into the fp rows and the
             frozen flag, so the fused kernel and the gather path both
             serve them at once. The tail crosses fp.

  "resident" Overload demotion (``extract_resident_pages``): a live
             sequence's pages exactly as they are served. Installed-frozen
             pages cross as the pool's own codes and codebooks, read off
             the pool and never re-solved, so a restore reproduces the
             values attention was reading; other full pages and the tail
             cross fp. Pure gathers: no solve.

Layout. The port's ``PagedKVPool`` is one leaf stacked over every layer
(the reference's stacked group axis), so a payload holds one tensor per
kind:

  full    (2, nL, n_fp, bs, Hkv, Dh)     fp full pages, k over v
  frozen  ((2, nL, n_q, bs, Hkv, Dc) uint8, (2, nL, n_q, L) f32)
  tail    (2, nL, tail_rows, Hkv, Dh)    the partial page's valid rows

``frozen_idx`` names the sequence positions the frozen rows cover, in row
order; ``full`` covers the other full positions in sequence order. A
"resident" payload's ``frozen_idx`` is ascending. A "frozen" payload keeps
the solve's rows in ``dispatch_freeze``'s sorted block order, so its
``frozen_idx`` is the positions sorted by source block id (the reference
gathers them back into sequence order on the device; the splice lands each
row at its position either way).

Each layer of a stacked pool views the first ``num_blocks`` pages of a
padded allocation (``kv_cache._pool_tensors``), so two pools of different
sizes have different layer strides. Extraction and splice therefore index
the block axis of the pool's (nL, num_blocks, ...) views by block id,
never a flat offset.

``extract_pages`` only enqueues work: on the card it records an event
after the gather (and a frozen payload keeps its solve's event from the
side stream), and ``PagePayload.is_ready`` queries them without
blocking. Payloads stage through host memory (``to_host``), which is where
the bytes are counted and where a network would sit between hosts;
``nbytes`` against ``fp_equiv_bytes`` is the measured migration
compression (1.0 for fp).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.obs.trace import NULL_TRACER

from .kv_cache import (PagedKVPool, PendingFreeze, dispatch_freeze,
                       install_freeze)

#: the payload modes
MODES = ("splice", "fp", "frozen", "resident")


def check_mode(mode: str) -> None:
    """Raise ``ValueError`` for a mode that is none of ``MODES``."""
    if mode not in MODES:
        raise ValueError(f"migrate mode {mode!r}: want one of "
                         f"{', '.join(MODES)}")


@dataclasses.dataclass
class PagePayload:
    """One migrated (or demoted) sequence's KV pages, staged for transfer.

    ``blocks`` are source-pool ids in sequence page order (a splice
    payload: every block the sequence holds in the shared pool).
    ``full``, ``frozen``, ``tail`` and ``frozen_idx`` are laid out as the
    module docstring says. ``event`` is the card's completion event of the
    gathers and ``solve_event`` that of a frozen payload's solve on the
    source pool's side stream (None on the CPU and once staged).
    ``shared_pages`` counts a splice payload's leading pages spliced from
    the prefix index (other live tables hold them): consumers queue
    freezes only for the rest. A resident payload never carries shared
    pages: its ``blocks`` start past them (``ResumeEntry.shared_pages``)."""

    mode: str
    blocks: list[int]
    n_tokens: int
    block_size: int
    n_full: int
    tail_rows: int
    shared_pages: int = 0
    full: torch.Tensor | None = None
    frozen: tuple | None = None
    tail: torch.Tensor | None = None
    frozen_idx: list[int] | None = None
    nbytes: int = 0
    fp_equiv_bytes: int = 0
    staged: bool = False
    event: object = None
    solve_event: object = None

    @property
    def n_pages(self) -> int:
        return self.n_full + (1 if self.tail_rows else 0)

    def _tensors(self):
        for t in (self.full, self.tail):
            if t is not None:
                yield t
        if self.frozen is not None:
            yield from self.frozen

    def _events(self):
        return [e for e in (self.event, self.solve_event) if e is not None]

    def is_ready(self) -> bool:
        """True once the gathers and any chained solve have landed
        (``to_host`` would not wait for the card). Never blocks: callers
        poll it before harvesting, so a long prefill or solve never stalls
        their loop."""
        return (self.staged or self.mode == "splice"
                or all(e.query() for e in self._events()))

    def to_host(self) -> "PagePayload":
        """Copy every tensor to host memory and count the bytes crossing
        (a splice payload stages nothing). On the card the copies first
        wait, on the device, for the gathers and the solve (whose codes
        were made on the side stream)."""
        if self.staged or self.mode == "splice":
            self.staged = True
            return self
        events = self._events()
        if events:
            stream = torch.cuda.current_stream(next(self._tensors()).device)
            for e in events:
                e.wait(stream)

        def host(t):
            # lint: sync(handoff and demotion staging is the wire: the harvest gates it on is_ready, and preempt blocks on it as the reference's DecodeWorker.preempt does)
            return t.cpu()
        if self.full is not None:
            self.full = host(self.full)
        if self.tail is not None:
            self.tail = host(self.tail)
        if self.frozen is not None:
            self.frozen = tuple(host(t) for t in self.frozen)
        self.nbytes = sum(t.numel() * t.element_size()
                          for t in self._tensors())
        self.staged, self.event, self.solve_event = True, None, None
        return self


@dataclasses.dataclass
class FinishedPrefill:
    """What a prefill worker hands the router or the decode worker: the
    sampled first token (and its logits when recorded), the sampler state
    to continue decoding with, and the staged pages."""

    req: object
    first_token: int
    payload: PagePayload
    rng: np.random.Generator
    last_logits: np.ndarray | None = None
    worker_id: int = -1

    @property
    def blocks(self) -> list[int]:
        return self.payload.blocks

    @property
    def shared_pages(self) -> int:
        return self.payload.shared_pages


def splice_of(blocks, n_tokens: int, block_size: int,
              shared_pages: int = 0) -> PagePayload:
    """The colocated payload: the sequence's blocks, already in place."""
    return PagePayload(mode="splice", blocks=[int(b) for b in blocks],
                       n_tokens=n_tokens, block_size=block_size,
                       n_full=n_tokens // block_size,
                       tail_rows=n_tokens % block_size,
                       shared_pages=shared_pages, staged=True)


def _payload(pool: PagedKVPool, mode: str, blocks, n_tokens: int,
             block_size: int) -> PagePayload:
    """An empty payload of ``mode`` for the sequence's first ``n_tokens``
    in ``blocks``, its fp-equivalent bytes counted."""
    if block_size != pool.block_size:
        raise ValueError(f"block_size {block_size} != the pool's "
                         f"{pool.block_size}")
    n_full, tail_rows = divmod(n_tokens, block_size)
    n_pages = n_full + (1 if tail_rows else 0)
    used = [int(b) for b in blocks[:n_pages]]
    if len(used) < n_pages:
        raise ValueError(f"{len(blocks)} blocks hold fewer than {n_tokens} "
                         f"tokens at block size {block_size}")
    nL, _, bs, Hkv, Dh = pool.k_fp.shape
    return PagePayload(
        mode=mode, blocks=used, n_tokens=n_tokens, block_size=block_size,
        n_full=n_full, tail_rows=tail_rows,
        fp_equiv_bytes=(2 * nL * (n_full * bs + tail_rows) * Hkv * Dh
                        * pool.k_fp.element_size()))


def _page_ids(ids, device) -> torch.Tensor:
    # lint: sync(pageable copy of the sequence's page ids, as the reference's _take_pages uploads them)
    return torch.as_tensor(np.asarray(ids, np.int64), device=device)


def _take(k: torch.Tensor, v: torch.Tensor, ids) -> torch.Tensor:
    """Pages ``ids`` of every layer of ``k`` and ``v``, k over v."""
    jb = _page_ids(ids, k.device)
    return torch.stack([k[:, jb], v[:, jb]])


def _finish_extract(pool: PagedKVPool, payload: PagePayload, t0,
                    tracer) -> PagePayload:
    """Gather the tail page's valid rows and mark the end of the gathers
    with an event on the card."""
    if payload.tail_rows:
        b, r = payload.blocks[payload.n_full], payload.tail_rows
        payload.tail = torch.stack([pool.k_fp[:, b, :r],
                                    pool.v_fp[:, b, :r]])
    if pool.device.type == "cuda":
        payload.event = torch.cuda.Event()
        payload.event.record(torch.cuda.current_stream(pool.device))
    tracer.complete("transfer", "extract", t0, mode=payload.mode,
                    pages=payload.n_pages, n_tokens=payload.n_tokens,
                    frozen_pages=len(payload.frozen_idx or ()),
                    fp_equiv_bytes=payload.fp_equiv_bytes)
    return payload


def extract_pages(pool: PagedKVPool, blocks, n_tokens: int, *,
                  block_size: int, mode: str, spec=None,
                  tracer=NULL_TRACER) -> PagePayload:
    """Gather one sequence's first ``n_tokens`` of KV out of ``pool`` as an
    "fp" or a "frozen" payload.

    ``blocks`` is the sequence's block-table prefix (sequence page order).
    Returns a payload of tensors on the pool's device; on the card the
    gathers are enqueued behind everything the current stream holds (the
    prefill that wrote the pages) and an event marks their end, so nothing
    here waits for the card. "frozen" needs ``spec`` (a count QuantSpec)
    and a quantized ``pool``: its full pages are solved by one
    ``dispatch_freeze`` on the pool's side stream, which waits for the
    current stream first. ``to_host()`` is where the transfer happens."""
    check_mode(mode)
    if mode in ("splice", "resident"):
        raise ValueError(f"extract_pages builds fp and frozen payloads; a "
                         f"{mode} payload comes from "
                         + ("splice_of" if mode == "splice"
                            else "extract_resident_pages"))
    t0 = tracer.now()
    payload = _payload(pool, mode, blocks, n_tokens, block_size)
    full = payload.blocks[:payload.n_full]
    if mode == "fp" and full:
        payload.full = _take(pool.k_fp, pool.v_fp, full)
    elif full:
        if spec is None:
            raise ValueError("frozen migration needs a kv_quant spec")
        # the freeze path is the wire format: one batched solve over every
        # (page, layer, k/v) row. It solves the pages in sorted block
        # order, which frozen_idx records (a row's codes do not depend on
        # its neighbours, so no padding to a shared batch size)
        pending = dispatch_freeze(pool, full, spec)
        payload.frozen = (pending.codes, pending.cb)
        payload.frozen_idx = [int(j) for j in np.argsort(full,
                                                         kind="stable")]
        payload.solve_event = pending.event
    return _finish_extract(pool, payload, t0, tracer)


def extract_resident_pages(pool: PagedKVPool, blocks, n_tokens: int,
                           frozen_idx, *, block_size: int,
                           tracer=NULL_TRACER) -> PagePayload:
    """Demote one live sequence's first ``n_tokens`` of KV exactly as it is
    served (overload tiered paging): a "resident" payload.

    ``frozen_idx`` lists the sequence positions of pages installed frozen:
    those cross as the pool's own packed codes and codebooks, never
    re-solved, so a restore reproduces the values attention was reading.
    Other full pages and the tail cross fp (their fp rows are their exact
    values; the caller drops their queued or in-flight solves and queues
    them again after restore). Pure gathers, so ``to_host`` waits on no
    solve."""
    t0 = tracer.now()
    payload = _payload(pool, "resident", blocks, n_tokens, block_size)
    n_full, used = payload.n_full, payload.blocks
    fset = {int(j) for j in frozen_idx if int(j) < n_full}
    payload.frozen_idx = sorted(fset)
    fp_ids = [used[j] for j in range(n_full) if j not in fset]
    if fp_ids:
        payload.full = _take(pool.k_fp, pool.v_fp, fp_ids)
    if fset:
        q_ids = [used[j] for j in payload.frozen_idx]
        payload.frozen = (_take(pool.k_codes, pool.v_codes, q_ids),
                          _take(pool.k_cb, pool.v_cb, q_ids))
    return _finish_extract(pool, payload, t0, tracer)


def _upload(a: torch.Tensor, pool: PagedKVPool,
            like: torch.Tensor) -> torch.Tensor:
    """A staged (2, nL, ...) tensor on the pool's device, checked against
    the pool tensor ``like`` (dtype, layers, trailing widths) it lands in."""
    k = min(2, like.dim() - 2)
    if a.dtype != like.dtype or a.shape[1] != pool.n_layers \
            or tuple(a.shape[-k:]) != tuple(like.shape[-k:]):
        raise ValueError(f"payload pages {tuple(a.shape)} {a.dtype} do not "
                         f"fit a pool of {tuple(like.shape)} {like.dtype}")
    # lint: sync(pageable copy of the staged pages, as the reference's splice_payload uploads them)
    return torch.as_tensor(a, device=pool.device)


def splice_payload(pool: PagedKVPool, payload: PagePayload, new_blocks, *,
                   tracer=NULL_TRACER) -> PagedKVPool:
    """Land a payload in ``pool`` at ``new_blocks`` (sequence page order,
    already allocated by the caller), in place: fp full pages by index
    assignment on the block axis of each layer's view, frozen ones through
    ``install_freeze`` (codes, codebooks, the reconstruction into the fp
    rows and the frozen flag, as an in-place freeze lands them), the tail
    page's valid rows into the first rows of its block (the rest of that
    page stays as the allocator left it). Everything is enqueued on the
    current stream, so the next decode step on it reads the landed pages.
    Returns the pool; the caller installs the block-table row."""
    if payload.mode == "splice":
        return pool             # the pages already live in this pool
    check_mode(payload.mode)
    if len(new_blocks) < payload.n_pages:
        raise ValueError(f"{len(new_blocks)} destination blocks for "
                         f"{payload.n_pages} pages")
    if payload.block_size != pool.block_size:
        raise ValueError(f"payload block size {payload.block_size} != the "
                         f"pool's {pool.block_size}")
    if payload.frozen is not None and not pool.quantized:
        raise ValueError(f"a {payload.mode} payload carries codes: it lands "
                         f"in a quantized pool only")
    t0 = tracer.now()
    payload.to_host()
    n_full = payload.n_full
    fidx = payload.frozen_idx or []
    if payload.full is not None:
        fset = set(fidx)
        jb = _page_ids([new_blocks[j] for j in range(n_full)
                        if j not in fset], pool.device)
        both = _upload(payload.full, pool, pool.k_fp)
        pool.k_fp[:, jb] = both[0]
        pool.v_fp[:, jb] = both[1]
    if payload.tail is not None:
        b, r = int(new_blocks[n_full]), payload.tail_rows
        both = _upload(payload.tail, pool, pool.k_fp)
        pool.k_fp[:, b, :r] = both[0]
        pool.v_fp[:, b, :r] = both[1]
    if payload.frozen is not None:
        codes, cb = payload.frozen
        install_freeze(pool, PendingFreeze(
            np.asarray([new_blocks[j] for j in fidx], np.int32),
            _upload(codes, pool, pool.k_codes), _upload(cb, pool, pool.k_cb)))
    tracer.complete("transfer", "splice", t0, mode=payload.mode,
                    pages=payload.n_pages, bytes=payload.nbytes,
                    fp_equiv_bytes=payload.fp_equiv_bytes)
    return pool
