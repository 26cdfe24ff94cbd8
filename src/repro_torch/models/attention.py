"""GQA self-attention with RoPE / qk-norm / softcap (port of
``repro/models/attention.py``: ``attention``, ``sdpa``, ``_pos_mask``,
``_sdpa_block``; MLA and cross-attention come with their model families).

Projections go through ``quant.serve.qmatmul``: dense weights are a plain
matmul, PTQ'd QuantizedTensor weights the codebook-dequant kernel.

A KV cache is anything ``cache.as_adapter`` accepts. Adapters that opt in
take the fused branches: single decode steps through ``fused_decode`` and
prefill chunks through ``fused_prefill``, which the paged serving cache
runs on the hand-written paged-attention kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.quant.serve import qmatmul

from .cache import as_adapter, supports_fused_decode, supports_fused_prefill
from .ffn import _dense
from .norms import init_rms, rms_norm
from .rope import apply_rope

BIG_NEG = -2.3819763e38


def init_attention(cfg, spec, gen: torch.Generator, dtype, device) -> dict:
    H, Hkv, Dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    p = {
        "wq": _dense(gen, D, H * Dh, dtype, device),
        "wk": _dense(gen, D, Hkv * Dh, dtype, device),
        "wv": _dense(gen, D, Hkv * Dh, dtype, device),
        "wo": _dense(gen, H * Dh, D, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rms(Dh, dtype, device)
        p["k_norm"] = init_rms(Dh, dtype, device)
    return p


def _as_rows(x, device) -> torch.Tensor:
    """Scalar or (B,) int offsets -> an int32 (Bm,) tensor, Bm in {1, B}."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).reshape(-1)
    return torch.tensor([int(x)], dtype=torch.int32, device=device)


def _pos_mask(Sq, Skv, *, k_start, causal, window, q_offset, kv_valid_len,
              device) -> torch.Tensor:
    """Position mask (Bm, Sq, Skv) with Bm in {1, B}."""
    q_off = _as_rows(q_offset, device)
    q_pos = q_off[:, None, None] + torch.arange(Sq, device=device)[None, :,
                                                                   None]
    k_pos = k_start + torch.arange(Skv, device=device)[None, None, :]
    mask = torch.ones((q_off.shape[0], Sq, Skv), dtype=torch.bool,
                      device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    if kv_valid_len is not None:
        kv = _as_rows(kv_valid_len, device)
        mask &= k_pos < kv[:, None, None]
    return mask


def _sdpa_block(q, k, v, *, causal, window, softcap, q_offset, kv_valid_len,
                repeat_kv=True):
    """One q-block of grouped attention. q: (B,Sq,Hq,Dh); k,v: (B,Skv,Hkv,*).
    Scores and the softmax run in f32 (the reference's
    ``preferred_element_type``)."""
    B, Sq, Hq, Dh = q.shape
    _, Skv, Hkv, Dv = v.shape
    G = Hq // Hkv
    if repeat_kv and G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
        Hkv, G = Hq, 1
    qr = q.reshape(B, Sq, Hkv, G, Dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qr.float(), k.float())
    logits = logits / math.sqrt(Dh)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    mask = _pos_mask(Sq, Skv, k_start=0, causal=causal, window=window,
                     q_offset=q_offset, kv_valid_len=kv_valid_len,
                     device=q.device)
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(BIG_NEG, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, Hq, Dv)


def sdpa(q, k, v, *, causal, window=None, softcap=None, q_offset=0,
         kv_valid_len=None, q_chunk=None):
    """Grouped SDPA, chunked over the query axis to bound the live logits
    buffer at (B, H, q_chunk, Skv). K/V repeat across the GQA group for
    multi-token queries only (a decode step would re-read the cache G
    times). The reference's online-softmax kv-chunk schedule for very long
    KV is not ported: every length runs the block form here."""
    B, Sq, Hq, Dh = q.shape
    rep = Sq > 1

    def one_chunk(qi, off):
        return _sdpa_block(qi, k, v, causal=causal, window=window,
                           softcap=softcap, q_offset=off,
                           kv_valid_len=kv_valid_len, repeat_kv=rep)

    if not q_chunk or Sq <= q_chunk or Sq % q_chunk != 0:
        return one_chunk(q, q_offset)
    outs = [one_chunk(q[:, i:i + q_chunk], q_offset + i)
            for i in range(0, Sq, q_chunk)]
    return torch.cat(outs, dim=1)


def attention(params, cfg, spec, x, positions, *, cache=None,
              cache_index=None, causal=True):
    """Self-attention. Returns (out, new_cache)."""
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = qmatmul(x, params["wq"]).reshape(B, S, H, Dh)
    k = qmatmul(x, params["wk"]).reshape(B, S, Hkv, Dh)
    v = qmatmul(x, params["wv"]).reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        adapter = as_adapter(cache)
        if supports_fused_decode(adapter, S, spec.window):
            # decode hot path: the adapter attends against its own storage
            # (the paged-attention kernel dequantizes frozen pages on chip)
            new_cache, out = adapter.fused_decode(
                q, k, v, softcap=cfg.attn_softcap)
        elif supports_fused_prefill(adapter, S, spec.window):
            # chunked-prefill hot path: the same kernel with W = C queries
            new_cache, out = adapter.fused_prefill(
                q, k, v, softcap=cfg.attn_softcap)
        else:
            new_cache, k_all, v_all, q_off, valid = adapter.update(
                k, v, cache_index)
            out = sdpa(q, k_all, v_all, causal=causal, window=spec.window,
                       softcap=cfg.attn_softcap, q_offset=q_off,
                       kv_valid_len=valid, q_chunk=cfg.attn_q_chunk)
    else:
        out = sdpa(q, k, v, causal=causal, window=spec.window,
                   softcap=cfg.attn_softcap, q_chunk=cfg.attn_q_chunk)
    y = qmatmul(out.reshape(B, S, H * Dh), params["wo"])
    return y, new_cache
