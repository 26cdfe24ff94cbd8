"""KV page handoff between serving workers, prefill to decode (port of
``repro/serving/transfer.py``, modes "splice" and "fp").

A finished prefill's pages leave the prefill worker's pool as a
``PagePayload`` and land in a decode worker's pool through
``splice_payload``: the decode worker allocates fresh block ids, the
payload's pages are scattered into its pool at those ids, and the
sequence's block-table row points at them (a page-table splice, not a pool
copy).

Two migration modes:

  "splice"   Colocated no-op: the prefill wrote straight into the decode
             worker's (shared) pool, so the payload carries block ids and
             no tensors. Zero bytes move.

  "fp"       Every written row crosses at full width: full pages whole,
             the trailing partial page only its valid rows. What
             disaggregated serving without codebook compression pays a
             handoff.

The reference's "frozen" mode (full pages solved on the source pool and
shipped as packed codes + codebooks) and its "resident" mode (a live
sequence's pages as currently served, for overload demotion) are not
ported yet: asking for either raises ``NotImplementedError``
(``ROADMAP.md`` A5c, and A6 for "resident").

Layout. The port's ``PagedKVPool`` is one leaf stacked over every layer
(the reference's stacked group axis), so a payload holds one tensor per
kind:

  full    (2, nL, n_full, bs, Hkv, Dh)   the full pages, k over v
  tail    (2, nL, tail_rows, Hkv, Dh)    the partial page's valid rows

Each layer of a stacked pool views the first ``num_blocks`` pages of a
padded allocation (``kv_cache._pool_tensors``), so two pools of different
sizes have different layer strides. Extraction and splice therefore index
the block axis of the pool's (nL, num_blocks, ...) views by block id,
never a flat offset.

``extract_pages`` only enqueues work: on the card it records an event
after the gather, and ``PagePayload.is_ready`` queries it without
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

from .kv_cache import PagedKVPool

#: the payload modes this port moves
MODES = ("splice", "fp")


def check_mode(mode: str) -> None:
    """Raise for a mode the port does not move: the reference's later
    modes name the roadmap item that ports them."""
    if mode in ("frozen", "resident"):
        raise NotImplementedError(
            f"page migration mode {mode!r} is not ported yet: ROADMAP.md "
            f"A5c ports 'frozen' (full pages solved through dispatch_freeze "
            f"on the source pool and landed by install_freeze); 'resident' "
            f"comes with overload (A6). Modes here: {', '.join(MODES)}")
    if mode not in MODES:
        raise ValueError(f"migrate mode {mode!r}: want one of "
                         f"{', '.join(MODES)}")


@dataclasses.dataclass
class PagePayload:
    """One migrated sequence's KV pages, staged for transfer.

    ``blocks`` are source-pool ids in sequence page order (a splice
    payload: every block the sequence holds in the shared pool). ``full``
    and ``tail`` are laid out as the module docstring says; ``event`` is
    the card's completion event of the gather (None on the CPU and once
    staged). ``shared_pages`` counts the sequence's leading pages spliced
    from the prefix index (referenced by other live tables): consumers
    queue freezes only for the rest."""

    mode: str
    blocks: list[int]
    n_tokens: int
    block_size: int
    n_full: int
    tail_rows: int
    shared_pages: int = 0
    full: torch.Tensor | None = None
    tail: torch.Tensor | None = None
    nbytes: int = 0
    fp_equiv_bytes: int = 0
    staged: bool = False
    event: object = None

    @property
    def n_pages(self) -> int:
        return self.n_full + (1 if self.tail_rows else 0)

    def is_ready(self) -> bool:
        """True once the gather has landed (``to_host`` would not wait for
        the card). Never blocks: callers poll it before harvesting, so a
        long prefill never stalls their loop."""
        return (self.staged or self.mode == "splice" or self.event is None
                or self.event.query())

    def to_host(self) -> "PagePayload":
        """Copy every tensor to host memory and count the bytes crossing
        (a splice payload stages nothing)."""
        if self.staged or self.mode == "splice":
            self.staged = True
            return self
        n = 0
        for name in ("full", "tail"):
            a = getattr(self, name)
            if a is None:
                continue
            # lint: sync(handoff staging is the wire; gated on is_ready, as the reference's PrefillWorker._harvest stages it)
            a = a.cpu()
            setattr(self, name, a)
            n += a.numel() * a.element_size()
        self.nbytes, self.staged, self.event = n, True, None
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


def extract_pages(pool: PagedKVPool, blocks, n_tokens: int, *,
                  block_size: int, mode: str,
                  tracer=NULL_TRACER) -> PagePayload:
    """Gather one sequence's first ``n_tokens`` of KV out of ``pool``.

    ``blocks`` is the sequence's block-table prefix (sequence page order).
    Returns a payload of tensors on the pool's device; on the card the
    gather is enqueued behind everything the current stream holds (the
    prefill that wrote the pages) and an event marks its end, so nothing
    here waits for the card. ``to_host()`` is where the transfer happens."""
    check_mode(mode)
    if mode == "splice":
        raise ValueError("a splice payload moves no pages: build it with "
                         "splice_of")
    if block_size != pool.block_size:
        raise ValueError(f"block_size {block_size} != the pool's "
                         f"{pool.block_size}")
    t0 = tracer.now()
    n_full, tail_rows = divmod(n_tokens, block_size)
    used = [int(b) for b in blocks[:n_full + (1 if tail_rows else 0)]]
    if len(used) < n_full + (1 if tail_rows else 0):
        raise ValueError(f"{len(blocks)} blocks hold fewer than {n_tokens} "
                         f"tokens at block size {block_size}")
    payload = PagePayload(mode=mode, blocks=used, n_tokens=n_tokens,
                          block_size=block_size, n_full=n_full,
                          tail_rows=tail_rows)
    nL, _, bs, Hkv, Dh = pool.k_fp.shape
    payload.fp_equiv_bytes = (2 * nL * (n_full * bs + tail_rows) * Hkv * Dh
                              * pool.k_fp.element_size())
    dev = pool.device
    if n_full:
        # lint: sync(pageable copy of the sequence's page ids, as the reference's _take_pages uploads them)
        jb = torch.as_tensor(np.asarray(used[:n_full], np.int64), device=dev)
        payload.full = torch.stack([pool.k_fp[:, jb], pool.v_fp[:, jb]])
    if tail_rows:
        b = used[n_full]
        payload.tail = torch.stack([pool.k_fp[:, b, :tail_rows],
                                    pool.v_fp[:, b, :tail_rows]])
    if dev.type == "cuda":
        payload.event = torch.cuda.Event()
        payload.event.record(torch.cuda.current_stream(dev))
    tracer.complete("transfer", "extract", t0, mode=mode,
                    pages=payload.n_pages, n_tokens=n_tokens,
                    fp_equiv_bytes=payload.fp_equiv_bytes)
    return payload


def _upload(a: torch.Tensor, pool: PagedKVPool) -> torch.Tensor:
    if a.dtype != pool.k_fp.dtype or a.shape[1] != pool.n_layers \
            or tuple(a.shape[-2:]) != tuple(pool.k_fp.shape[-2:]):
        raise ValueError(f"payload pages {tuple(a.shape)} {a.dtype} do not "
                         f"fit a pool of {tuple(pool.k_fp.shape)} "
                         f"{pool.k_fp.dtype}")
    # lint: sync(pageable copy of the staged pages, as the reference's splice_payload uploads them)
    return torch.as_tensor(a, device=pool.device)


def splice_payload(pool: PagedKVPool, payload: PagePayload, new_blocks, *,
                   tracer=NULL_TRACER) -> PagedKVPool:
    """Land a payload in ``pool`` at ``new_blocks`` (sequence page order,
    already allocated by the caller), in place: the full pages by index
    assignment on the block axis of each layer's view, the tail page's
    valid rows into the first rows of its block (the rest of that page
    stays as the allocator left it). Returns the pool; the caller installs
    the block-table row."""
    if payload.mode == "splice":
        return pool             # the pages already live in this pool
    check_mode(payload.mode)
    if len(new_blocks) < payload.n_pages:
        raise ValueError(f"{len(new_blocks)} destination blocks for "
                         f"{payload.n_pages} pages")
    if payload.block_size != pool.block_size:
        raise ValueError(f"payload block size {payload.block_size} != the "
                         f"pool's {pool.block_size}")
    t0 = tracer.now()
    payload.to_host()
    n_full = payload.n_full
    if payload.full is not None:
        # lint: sync(pageable copy of the destination page ids)
        jb = torch.as_tensor(np.asarray(new_blocks[:n_full], np.int64),
                             device=pool.device)
        both = _upload(payload.full, pool)
        pool.k_fp[:, jb] = both[0]
        pool.v_fp[:, jb] = both[1]
    if payload.tail is not None:
        b, r = int(new_blocks[n_full]), payload.tail_rows
        both = _upload(payload.tail, pool)
        pool.k_fp[:, b, :r] = both[0]
        pool.v_fp[:, b, :r] = both[1]
    tracer.complete("transfer", "splice", t0, mode=payload.mode,
                    pages=payload.n_pages, bytes=payload.nbytes,
                    fp_equiv_bytes=payload.fp_equiv_bytes)
    return pool
