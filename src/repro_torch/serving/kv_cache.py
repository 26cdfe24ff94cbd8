"""Paged KV cache: fixed-size blocks, a refcounted free-list allocator,
per-sequence block tables, codebook-frozen pages and the fused read path
(port of ``repro/serving/kv_cache.py``).

Layout. ``PagedKVPool`` holds every attention layer's pools stacked on a
leading layer axis (the reference's stacked group axis):

  k_fp/v_fp     (nL, nb, bs, Hkv, Dh)  fp pages, the write-hot pool.
  k_codes/...   (nL, nb, bs, Hkv, Dc)  uint8 codes of frozen pages
                (Dc = Dh/2: two 4-bit codes per byte, split-half layout,
                see ``kernels.pack4``).
  k_cb/v_cb     (nL, nb, L) f32        per-page codebooks (kmeans_ls).
  blk_q         (nb,) bool             page is frozen: codes are
                authoritative, fp holds their reconstruction. One flag per
                page for every layer, since a freeze event always covers
                all layers.

``with_tables`` cuts per-layer ``PagedKVCache`` views (the model's cache
list) that carry this step's ``block_table`` (B, mb) and ``seq_lens`` (B,).
Block 0 is the null page: idle slots point at it and their masked writes
land there.

Writes go into the pool IN PLACE (the reference's pools are immutable and
every step returns fresh ones): a view's ``_write`` scatters into the
stacked storage, and ``_install`` scatters codes, codebooks and
reconstructions into it. That saves a copy of the pool per layer per step.
The reference's tree helpers ``map_layers``, ``merge_pools`` and
``freeze_markers`` have no job here: ``with_tables`` cuts the per-layer
views, writes need no merging, and a ``PendingFreeze`` carries its own
completion event.

Freezing is ``dispatch_freeze`` (every (page, layer, k/v) row of the event
through the spec's batched device solver in one call, on a side CUDA stream
so decode steps overlap it) and ``install_freeze`` (the main stream waits
for the solve's event, then scatters). ``PendingFreeze.is_ready`` is the
event's ``query()``: the counterpart of JAX's async dispatch. On the CPU,
freezing is synchronous.

Reads: ``fused_decode``/``fused_prefill`` hand the raw pools and table to
``kernels.paged_decode_attention`` (the Hopper kernel on the card: frozen
pages cross HBM as packed codes); ``update`` gathers every table page at
full width for the caller's sdpa (installing a freeze materializes
``cb[codes]`` into the fp rows, so the gather path serves the same values).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import QuantSpec, device_methods
from repro_torch.kernels import (pack4, paged_decode_attention,
                                 paged_prefill_attention, unpack4)

# ------------------------------------------------------------- allocator


class PoolExhausted(MemoryError):
    """Typed allocator failure carrying the shortfall."""

    def __init__(self, requested: int, free: int):
        self.requested = requested
        self.free = free
        super().__init__(f"asked {requested} blocks, {free} free")


class DoubleFree(ValueError):
    """Freeing a block that is not live (already free, or never handed
    out); the offending id rides along."""

    def __init__(self, block: int):
        self.block = block
        super().__init__(f"double free / foreign block {block}")


class BlockAllocator:
    """Host-side free-list page allocator with per-page refcounts. Block 0
    is never handed out.

    ``alloc`` hands out pages at rc 1; ``retain`` adds a reference per id
    for a table sharing a live page; ``free`` drops one and releases a page
    to the free list when its last reference goes. ``free`` returns the ids
    actually released."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least one allocatable block")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))   # pop() -> low ids
        self._used: set[int] = set()
        self._rc: dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    def refcount(self, b: int) -> int:
        return self._rc.get(int(b), 0)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise PoolExhausted(n, len(self._free))
        out = [self._free.pop() for _ in range(n)]
        self._used.update(out)
        for b in out:
            self._rc[b] = 1
        return out

    def retain(self, ids) -> None:
        for b in ids:
            b = int(b)
            if b not in self._used:
                raise ValueError(f"retain of non-live block {b}")
            self._rc[b] += 1

    def free(self, ids) -> list[int]:
        """Drop one reference per id; release pages whose rc hits 0.
        Freeing an id that is not live raises ``DoubleFree``."""
        released: list[int] = []
        for b in ids:
            b = int(b)
            if b not in self._used:
                raise DoubleFree(b)
            self._rc[b] -= 1
            if self._rc[b] == 0:
                del self._rc[b]
                self._used.remove(b)
                self._free.append(b)
                released.append(b)
        return released


# ------------------------------------------------------------- paged cache


@dataclasses.dataclass
class PagedKVCache:
    """One attention layer's pools (views into the stacked pool, or tensors
    of its own) plus this batch's table view. Implements the adapter
    protocol of ``repro_torch.models.cache`` with both fused extensions."""

    k_fp: torch.Tensor
    v_fp: torch.Tensor
    k_codes: torch.Tensor
    v_codes: torch.Tensor
    k_cb: torch.Tensor
    v_cb: torch.Tensor
    blk_q: torch.Tensor
    block_table: torch.Tensor     # (B, mb) int32
    seq_lens: torch.Tensor        # (B,) int32
    block_size: int
    quantized: bool
    packed: bool
    fused: bool = False           # decode reads go through the kernel
    fused_window: int = 1         # max fused query window
    prefill_fused: bool = False   # prefill chunks read through the kernel

    def _write(self, k, v) -> None:
        """Scatter k/v (B, S, Hkv, Dh) into the fp pool at per-sequence
        positions, in place (block 0 absorbs idle slots' writes)."""
        B, S, Hkv, Dh = k.shape
        bs = self.block_size
        pos = self.seq_lens.long()[:, None] + torch.arange(
            S, device=k.device)[None]                        # (B, S)
        blk = torch.gather(self.block_table.long(), 1, pos // bs)
        off = pos % bs
        ix = (blk.reshape(-1), off.reshape(-1))
        self.k_fp[ix] = k.reshape(B * S, Hkv, Dh).to(self.k_fp.dtype)
        self.v_fp[ix] = v.reshape(B * S, Hkv, Dh).to(self.v_fp.dtype)

    def update(self, k, v, cache_index):
        """Write k/v at per-sequence positions; gather pages for sdpa.
        ``cache_index`` (the ring-cache scalar) is ignored."""
        del cache_index
        S = k.shape[1]
        self._write(k, v)
        return (self, self._gather(self.k_fp), self._gather(self.v_fp),
                self.seq_lens, self.seq_lens + S)

    @property
    def use_fused_decode(self) -> bool:
        return self.fused

    def _attend(self, q, valid_or_offset, prefill: bool, softcap):
        fn = paged_prefill_attention if prefill else paged_decode_attention
        return fn(q, self.k_fp, self.v_fp, self.k_codes, self.v_codes,
                  self.k_cb, self.v_cb, self.blk_q, self.block_table,
                  valid_or_offset, softcap=softcap,
                  quantized=self.quantized, packed=self.packed)

    def fused_decode(self, q, k, v, *, softcap=None):
        """Decode write + fused paged attention over a 1..fused_window
        query window; returns (self, out (B, S, Hq, Dh))."""
        S = q.shape[1]
        if S > max(self.fused_window, 1):
            raise ValueError(f"fused_decode window {S} exceeds "
                             f"fused_window {self.fused_window}")
        self._write(k, v)
        valid = self.seq_lens + S
        out = self._attend(q if S > 1 else q[:, 0], valid, False, softcap)
        return self, (out if S > 1 else out[:, None]).to(q.dtype)

    @property
    def use_fused_prefill(self) -> bool:
        return self.prefill_fused

    def fused_prefill(self, q, k, v, *, softcap=None):
        """Prefill-chunk write + fused paged attention: the chunk's C
        queries are the last C positions of the post-write valid length."""
        self._write(k, v)
        out = self._attend(q, self.seq_lens, True, softcap)
        return self, out.to(q.dtype)

    def _gather(self, fp):
        """Pages for this batch: (B, mb*bs, Hkv, Dh) from the fp pool
        (frozen pages hold their reconstruction there)."""
        t = self.block_table.long()
        B, mb = t.shape
        _, bs, H, D = fp.shape
        return fp[t].reshape(B, mb * bs, H, D)


@dataclasses.dataclass
class PagedKVPool:
    """Every layer's pools, stacked on a leading layer axis."""

    k_fp: torch.Tensor
    v_fp: torch.Tensor
    k_codes: torch.Tensor
    v_codes: torch.Tensor
    k_cb: torch.Tensor
    v_cb: torch.Tensor
    blk_q: torch.Tensor
    block_size: int
    quantized: bool
    packed: bool
    fused: bool = False
    fused_window: int = 1
    _stream: object = None         # side stream for async freezes (CUDA)

    @property
    def n_layers(self) -> int:
        return self.k_fp.shape[0]

    @property
    def device(self) -> torch.device:
        return self.k_fp.device

    def layer(self, i: int, block_table, seq_lens) -> PagedKVCache:
        return PagedKVCache(
            self.k_fp[i], self.v_fp[i], self.k_codes[i], self.v_codes[i],
            self.k_cb[i], self.v_cb[i], self.blk_q, block_table, seq_lens,
            self.block_size, self.quantized, self.packed, fused=self.fused,
            fused_window=self.fused_window)

    def freeze_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return self._stream


def _pool_tensors(cfg_or_shape, *, num_blocks, block_size, n_layers,
                  quantized, num_values, dtype, device):
    Hkv, Dh = cfg_or_shape
    packed = quantized and num_values <= 16
    if packed and Dh % 2:
        raise ValueError(f"packed codes need an even head_dim, got {Dh}")
    Dc = Dh // 2 if packed else Dh
    fp = (n_layers, num_blocks, block_size, Hkv, Dh)
    cshape = (n_layers, num_blocks, block_size, Hkv, Dc) if quantized \
        else (n_layers, 1, 1, 1, 1)
    cbshape = (n_layers, num_blocks, num_values) if quantized \
        else (n_layers, 1, 1)
    z = lambda s, dt: torch.zeros(s, dtype=dt, device=device)
    return dict(k_fp=z(fp, dtype), v_fp=z(fp, dtype),
                k_codes=z(cshape, torch.uint8), v_codes=z(cshape, torch.uint8),
                k_cb=z(cbshape, torch.float32), v_cb=z(cbshape, torch.float32),
                blk_q=z((num_blocks if quantized else 1,), torch.bool),
                block_size=block_size, quantized=quantized, packed=packed)


def init_paged_layer(cfg, *, num_blocks, block_size, batch, max_blocks,
                     quantized, num_values, dtype, device, fused=False,
                     fused_window=1) -> PagedKVCache:
    """A standalone one-layer cache (tests, kernels)."""
    t = _pool_tensors((cfg.n_kv_heads, cfg.head_dim), num_blocks=num_blocks,
                      block_size=block_size, n_layers=1, quantized=quantized,
                      num_values=num_values, dtype=dtype, device=device)
    for k in ("k_fp", "v_fp", "k_codes", "v_codes", "k_cb", "v_cb"):
        t[k] = t[k][0]
    return PagedKVCache(
        **t, block_table=torch.zeros((batch, max_blocks), dtype=torch.int32,
                                     device=device),
        seq_lens=torch.zeros((batch,), dtype=torch.int32, device=device),
        fused=fused, fused_window=fused_window)


def init_paged_cache(cfg, *, num_blocks, block_size, quantized=False,
                     num_values=16, fused=False, fused_window=1,
                     device) -> PagedKVPool:
    """The model's paged pool: one stacked pool over every layer."""
    for spec in cfg.layer_specs():
        if spec.mixer != "attn":
            raise ValueError(f"paged serving supports attention mixers "
                             f"only, got {spec.mixer}")
    t = _pool_tensors((cfg.n_kv_heads, cfg.head_dim), num_blocks=num_blocks,
                      block_size=block_size, n_layers=cfg.n_layers,
                      quantized=quantized, num_values=num_values,
                      dtype=cfg.dtype("compute"), device=device)
    return PagedKVPool(**t, fused=fused, fused_window=fused_window)


def paged_layer_from_reference(leaf: dict, *, block_size: int,
                               quantized: bool, packed: bool,
                               device) -> PagedKVCache:
    """One reference paged-cache layer, given as numpy arrays under the
    reference's field names (k_fp, v_fp, k_codes, v_codes, k_cb, v_cb,
    blk_q, block_table, seq_lens), as a port layer cache."""
    from repro_torch.models.convert import _t

    t = {k: _t(leaf[k], device) for k in ("k_fp", "v_fp", "k_codes",
                                           "v_codes", "k_cb", "v_cb")}
    return PagedKVCache(
        **t, blk_q=_t(leaf["blk_q"], device, torch.bool),
        block_table=_t(leaf["block_table"], device, torch.int32),
        seq_lens=_t(leaf["seq_lens"], device, torch.int32),
        block_size=block_size, quantized=quantized, packed=packed)


# ----------------------------------------------- per-step views


def with_tables(pool: PagedKVPool, block_table: np.ndarray,
                seq_lens: np.ndarray) -> list[PagedKVCache]:
    """Per-layer views carrying this step's host-managed table and lengths
    (copied to the pool's device once, shared by every layer). The table
    may be narrower than ``max_blocks``: the worker clamps it to the blocks
    the longest live sequence needs."""
    dev = pool.device
    # lint: sync(pageable copy of the step's block table; ROADMAP A2)
    bt = torch.as_tensor(np.ascontiguousarray(block_table, np.int32)).to(dev)
    # lint: sync(the same copy of the step's lengths)
    sl = torch.as_tensor(np.ascontiguousarray(seq_lens, np.int32)).to(dev)
    return [pool.layer(i, bt, sl) for i in range(pool.n_layers)]


def with_prefill_fused(views: list[PagedKVCache]) -> list[PagedKVCache]:
    """Route prefill-chunk attention through the fused kernel."""
    for v in views:
        v.prefill_fused = True
    return views


# ----------------------------------------------- spec resolution


def resolve_kv_spec(spec=None, *, method=None, num_values=None) -> QuantSpec:
    """Coerce the engine's ``kv_quant`` argument to a validated QuantSpec:
    a QuantSpec, a compact string ("kmeans_ls@16"), or the legacy
    (method, num_values) pair. Page freezing needs a method with a batched
    device solver; anything else raises, naming those methods."""
    capable = f"methods that can freeze pages: {', '.join(device_methods())}"
    try:
        if isinstance(spec, QuantSpec) or (
                isinstance(spec, str) and ("@" in spec or ":" in spec)):
            if num_values is not None or method is not None:
                raise TypeError(
                    f"got both a kv_quant spec ({spec!s}) and loose "
                    f"method=/num_values= arguments; fold them into the "
                    f"spec, e.g. 'kmeans_ls@{num_values or 16}'")
            out = QuantSpec.parse(spec)
        else:
            m = spec if isinstance(spec, str) else method
            out = QuantSpec(m or "kmeans_ls",
                            num_values=16 if num_values is None
                            else num_values)
    except ValueError as e:
        raise ValueError(f"bad kv_quant spec: {e}\npage freezing needs a "
                         f"count-parameterised method — {capable}") from None
    if out.param_kind != "count" or not out.device_capable:
        raise ValueError(f"kv_quant spec {str(out)!r} cannot freeze pages — "
                         f"{capable}")
    return out


# ----------------------------------------------- freezing


def _stacked(cache) -> PagedKVPool:
    """A pool view of a standalone layer (leading layer axis of 1)."""
    if isinstance(cache, PagedKVPool):
        return cache
    s = lambda t: t.unsqueeze(0)
    return PagedKVPool(s(cache.k_fp), s(cache.v_fp), s(cache.k_codes),
                       s(cache.v_codes), s(cache.k_cb), s(cache.v_cb),
                       cache.blk_q, cache.block_size, cache.quantized,
                       cache.packed)


def _solve_pages(pool: PagedKVPool, jb: torch.Tensor, spec: QuantSpec):
    """Gather pages ``jb`` of every layer and solve their codebooks in one
    batched call. Returns (codes (2, nL, P, bs, Hkv, Dc) uint8,
    cb (2, nL, P, L) f32), k stacked over v."""
    both = torch.stack([pool.k_fp[:, jb], pool.v_fp[:, jb]])
    rows = both.reshape(-1, int(np.prod(both.shape[-3:])))
    codes, cb = spec.device_solve(rows)
    codes = codes.reshape(both.shape)
    cb = cb.reshape(both.shape[:-3] + (spec.num_values,))
    if pool.packed:
        codes = pack4(codes)
    return codes, cb


def _install(pool: PagedKVPool, jb: torch.Tensor, codes, cb) -> None:
    """Scatter solved pages into the pool in place: codes, codebooks, the
    reconstruction ``cb[codes]`` into the fp rows (so the gather path
    serves quantized values), and the frozen flag."""
    idx = unpack4(codes) if pool.packed else codes.long()
    flat = idx.reshape(cb.shape[:-1] + (-1,))                 # (2, nL, P, E)
    deq = torch.gather(cb, -1, flat).reshape(idx.shape)
    pool.k_fp[:, jb] = deq[0].to(pool.k_fp.dtype)
    pool.v_fp[:, jb] = deq[1].to(pool.v_fp.dtype)
    pool.k_codes[:, jb] = codes[0]
    pool.v_codes[:, jb] = codes[1]
    pool.k_cb[:, jb] = cb[0]
    pool.v_cb[:, jb] = cb[1]
    pool.blk_q[jb] = True


class PendingFreeze:
    """Handle for an in-flight freeze: the solver outputs (still computing
    on the side stream on the card) and the page ids they target. Until
    ``install_freeze`` those pages keep serving from the exact fp pool, so
    decode steps issued meanwhile do not depend on the solve. ``drop``
    forgets pages whose sequence finished (a freed page must not be
    installed over its next owner); it only flips a host-side mask."""

    def __init__(self, bids: np.ndarray, codes, cb, event=None):
        self.bids = np.asarray(bids, np.int32)
        self.keep = np.ones(self.bids.shape, bool)
        self.codes, self.cb = codes, cb
        self.event = event

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            # lint: sync(end-of-run drain: waits for the freeze's stream)
            self.event.synchronize()

    def drop(self, freed_ids) -> None:
        self.keep &= ~np.isin(self.bids,
                              np.asarray(list(freed_ids), np.int32))

    def kept_pages(self) -> list[int]:
        """Distinct page ids an install marks frozen (padding duplicates
        collapsed, dropped pages excluded), sorted."""
        return sorted({int(b) for b in self.bids[self.keep]})


def dispatch_freeze(cache, block_ids, spec=None, *,
                    num_values=None) -> PendingFreeze:
    """Start the batched solve for ``block_ids`` in every layer; returns
    at once with a PendingFreeze (the pool is not modified). On the card
    the solve runs on the pool's side stream after everything the main
    stream has queued (the pages' writes included)."""
    pool = _stacked(cache)
    if not pool.quantized:
        raise ValueError("dispatch_freeze needs a quantized pool")
    spec = resolve_kv_spec(spec, num_values=num_values).replace(seed=0)
    bids = np.asarray(sorted(block_ids), np.int32)
    if pool.device.type != "cuda":
        jb = torch.as_tensor(bids.astype(np.int64))
        return PendingFreeze(bids, *_solve_pages(pool, jb, spec))
    side = pool.freeze_stream()
    side.wait_stream(torch.cuda.current_stream(pool.device))
    with torch.cuda.stream(side):
        # the copy waits for the side stream, which waits for the main one
        # lint: sync(pageable copy of the page ids; ROADMAP A2)
        jb = torch.as_tensor(bids.astype(np.int64)).to(pool.device)
        codes, cb = _solve_pages(pool, jb, spec)
        event = torch.cuda.Event()
        event.record(side)
    return PendingFreeze(bids, codes, cb, event)


def install_freeze(cache, pending: PendingFreeze):
    """Scatter a freeze into the pool (in place) and flip ``blk_q``; from
    the next step the kept pages serve from codes. On the card the main
    stream first waits for the solve's event."""
    if not pending.keep.any():
        return cache
    pool = _stacked(cache)
    codes, cb = pending.codes, pending.cb
    if pending.event is not None:
        main = torch.cuda.current_stream(pool.device)
        main.wait_event(pending.event)
        # allocated on the side stream, consumed here: keep the memory
        # from being reused before the main stream is done with it
        codes.record_stream(main)
        cb.record_stream(main)
    # lint: sync(pageable copy of the kept pages' slots; ROADMAP A2)
    sel = torch.as_tensor(np.flatnonzero(pending.keep)).to(pool.device)
    # lint: sync(the same copy of their page ids)
    jb = torch.as_tensor(pending.bids[pending.keep].astype(np.int64)).to(
        pool.device)
    _install(pool, jb, codes[:, :, sel], cb[:, :, sel])
    return cache


def freeze_blocks(cache, block_ids, spec=None, *, method=None,
                  num_values=None):
    """Quantize full pages ``block_ids`` in every layer and install them
    (dispatch + install in one call)."""
    if not len(block_ids):
        return cache
    spec = resolve_kv_spec(spec, method=method, num_values=num_values)
    return install_freeze(cache, dispatch_freeze(cache, block_ids, spec))


def thaw_blocks(cache, block_ids):
    """Clear the frozen flag of freed pages (reallocation starts fp)."""
    pool = _stacked(cache)
    if len(block_ids) and pool.quantized:
        ids = torch.as_tensor(np.asarray(sorted(block_ids), np.int64))
        # lint: sync(pageable copy of the freed page ids; ROADMAP A2)
        pool.blk_q[ids.to(pool.device)] = False
    return cache


# ----------------------------------------------- footprint accounting


def page_bytes(cfg, block_size: int, *, quantized: bool, num_values: int,
               n_layers_attn: int | None = None) -> dict:
    """Bytes one page costs across all attention layers, fp vs frozen."""
    n_attn = (n_layers_attn if n_layers_attn is not None
              else sum(1 for s in cfg.layer_specs() if s.mixer == "attn"))
    elems = block_size * cfg.n_kv_heads * cfg.head_dim
    fp = 2 * elems * cfg.dtype("compute").itemsize          # k and v
    if not quantized:
        return {"fp": n_attn * fp, "frozen": n_attn * fp, "n_attn": n_attn}
    bits = 4 if num_values <= 16 else 8
    frozen = 2 * ((elems * bits + 7) // 8 + num_values * 4)
    return {"fp": n_attn * fp, "frozen": n_attn * frozen, "n_attn": n_attn}
