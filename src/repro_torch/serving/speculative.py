"""Speculative decoding, draft side (port of
``repro/serving/speculative.py``).

``DraftWorker`` mirrors a decode worker's slot geometry on its own small
(unquantized, gather-path) paged pool and proposes ``k`` tokens per verify
step with a reduced draft model. The target-side verify/accept/rollback
lives in ``workers.DecodeWorker._spec_decode_step``; the contract between
the two is the per-slot length invariant

    draft.lens[slot] <= worker.lens[slot]            (always)
    rows 0..draft.lens-1 of the draft cache hold KV of the ACCEPTED
    context only (prompt + emitted tokens)

so a rejected suffix needs no cache surgery on either side: ``sync``
shrinks ``lens`` to the accepted watermark, and the next propose call's
catch-up window rewrites the stale rows in place (writes always land
contiguously at ``lens``).

Proposing is two shapes whatever k is: one (B, 2) catch-up window (after
a fully accepted step the draft is one token behind the target, after a
rollback zero behind, so the pending suffix is never longer than 2), then
k-1 single-token steps.

``derive_draft`` builds the default draft: the target truncated to the
first half of its layers, embed, final norm and head shared. The port
keeps the layers as a list, so the truncation is a slice of that list
(the reference slices its stacked ``groups`` axis). A PTQ'd target's
draft serves the same codes, through the same dequant kernel.

With prefix sharing the draft always prefills the whole prompt on its own
pool (draft pages are per-slot private), so target-side sharing is
invisible here. On the target a shared page is frozen (quantized pool) or
a full prompt page (fp pool) before it is ever published, and rollback
touches only pages past the accepted watermark, which lies past the
shared prompt prefix: rollback never mutates a page another table holds.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import models
from repro_torch.obs.trace import NULL_TRACER

from .kv_cache import BlockAllocator, init_paged_cache, with_tables


def window_step(params, cfg, toks: np.ndarray, pool, table, lens):
    """One multi-token decode window over ``pool`` (the verify pass and
    the draft's catch-up/propose steps; W = 1 is a decode step): host
    tokens (B, W), table (B, mb) and lengths (B,) -> logits (B, W, V) on
    the pool's device."""
    views = with_tables(pool, table, lens)
    logits, _ = models.decode_window(
        # lint: sync(pageable copy of the window's token ids; ROADMAP A2)
        params, cfg, torch.as_tensor(toks).to(pool.device), views,
        views[0].seq_lens)
    return logits


def derive_draft(params, cfg):
    """Layer-truncated draft of a target: the first half of its layer
    groups (at least one) plus the shared embed, final norm and head.
    Returns (draft_params, draft_cfg): a real reduced config with the
    target's vocab."""
    if cfg.family != "lm" or cfg.head_layers:
        raise ValueError("derive_draft truncates the layers of a plain "
                         "decoder LM")
    g = len(cfg.group)
    keep = max(cfg.n_groups // 2, 1) * g
    draft_cfg = dataclasses.replace(cfg, name=f"{cfg.name}-draft{keep // g}",
                                    n_layers=keep).validate()
    draft_params = dict(params)
    draft_params["layers"] = params["layers"][:keep]
    return draft_params, draft_cfg


class DraftWorker:
    """Draft-model mirror of one decode worker: same slot indexing, own
    page pool, allocator and table, fp cache on the gather path (draft KV
    is throwaway). ``counters`` counts its model calls: one prefill an
    attach, k windows a propose."""

    def __init__(self, params, cfg, *, device, max_slots: int,
                 block_size: int, max_blocks: int, worker_id: int = 0,
                 tracer=None):
        self.params, self.cfg = params, cfg
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._trk = f"draft/w{worker_id}"
        self.device = torch.device(device)
        self.block_size = block_size
        self.max_blocks = max_blocks
        self.num_blocks = max_slots * max_blocks + 1
        self.pool = init_paged_cache(cfg, num_blocks=self.num_blocks,
                                     block_size=block_size,
                                     device=self.device)
        self.alloc = BlockAllocator(self.num_blocks)
        self.table = np.zeros((max_slots, max_blocks), np.int32)
        self.lens = np.zeros((max_slots,), np.int32)   # valid draft KV rows
        self.plen = np.zeros((max_slots,), np.int32)   # prompt length
        self.blocks: list[list[int]] = [[] for _ in range(max_slots)]
        self.counters = {"draft_prefills": 0, "draft_steps": 0}

    # ------------------------------------------------------------ lifecycle

    def attach(self, slot: int, prompt, n_blocks: int) -> None:
        """Prefill the prompt on the draft model into this slot's pages
        (the target's worst-case block count, so the verify window's
        optimistic writes always fit here too)."""
        t0 = self.tracer.now()
        blocks = self.alloc.alloc(n_blocks)
        self.blocks[slot] = blocks
        self.table[slot] = 0
        self.table[slot, :len(blocks)] = blocks
        P = len(prompt)
        ppad = -(-P // self.block_size) * self.block_size
        toks = np.zeros((1, ppad), np.int32)
        toks[0, :P] = prompt
        views = with_tables(self.pool,
                            np.asarray([blocks[:ppad // self.block_size]],
                                       np.int32), np.zeros((1,), np.int32))
        models.prefill(
            self.params, self.cfg,
            # lint: sync(pageable copy of the draft prompt's ids; ROADMAP A2)
            {"tokens": torch.as_tensor(toks).to(self.device)}, views)
        self.lens[slot] = P
        self.plen[slot] = P
        self.counters["draft_prefills"] += 1
        self.tracer.complete(self._trk, "draft_prefill", t0, slot=slot,
                             prompt_len=P)

    def release(self, slot: int) -> None:
        self.alloc.free(self.blocks[slot])
        self.blocks[slot] = []
        self.table[slot] = 0
        self.lens[slot] = 0
        self.plen[slot] = 0

    def sync(self, slot: int, accepted_len: int) -> None:
        """Roll this slot back to the target's accepted watermark. Rows at
        or past it hold rejected drafts' KV; shrinking ``lens`` is the
        whole rollback: the next catch-up window overwrites them."""
        self.lens[slot] = min(int(self.lens[slot]), int(accepted_len))

    # ------------------------------------------------------------ proposing

    def _step(self, toks: np.ndarray) -> np.ndarray:
        need = int(self.lens.max()) + toks.shape[1]
        mb = max(1, -(-need // self.block_size))
        logits = window_step(self.params, self.cfg, toks, self.pool,
                             self.table[:, :mb], self.lens)
        self.counters["draft_steps"] += 1
        # lint: sync(draft tokens feed the host-side proposal loop)
        return logits.argmax(-1).cpu().numpy()               # (B, W)

    def propose(self, active, slots, k: int) -> dict[int, list[int]]:
        """k draft tokens per active slot, batched across slots.

        ``slots`` is the decode worker's slot list (``out`` carries the
        accepted token history; token j's KV row is ``plen + j``). First a
        (B, 2) catch-up window writes the accepted rows this cache is
        missing and yields draft 1, then k-1 single-token steps yield the
        rest. Rows written past a slot's true pending length are scratch:
        contiguous writes at ``lens`` overwrite them before ``lens``
        covers them."""
        t0 = self.tracer.now()
        B = self.table.shape[0]
        Wc = 2
        toks = np.zeros((B, Wc), np.int32)
        wlen = np.ones((B,), np.int32)
        for i in active:
            pend = slots[i].out[int(self.lens[i]) - int(self.plen[i]):]
            if not 1 <= len(pend) <= Wc:
                raise RuntimeError(f"draft slot {i} is {len(pend)} tokens "
                                   f"behind the target (want 1 or 2)")
            toks[i, :len(pend)] = pend
            toks[i, len(pend):] = pend[-1]
            wlen[i] = len(pend)
        preds = self._step(toks)
        out: dict[int, list[int]] = {}
        for i in active:
            out[i] = [int(preds[i, wlen[i] - 1])]
            self.lens[i] += int(wlen[i])
        for _ in range(k - 1):
            toks1 = np.zeros((B, 1), np.int32)
            for i in active:
                toks1[i, 0] = out[i][-1]
            preds = self._step(toks1)
            for i in active:
                out[i].append(int(preds[i, 0]))
                self.lens[i] += 1
        self.tracer.complete(self._trk, "draft_propose", t0, k=k,
                             active=len(active))
        return out
