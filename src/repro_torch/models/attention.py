"""Attention mixers (port of ``repro/models/attention.py``): GQA
self-attention with RoPE or M-RoPE, qk-norm, softcap and a local window;
whisper's appended cross-attention; deepseek's multi-head latent
attention (MLA).

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
from repro_torch.runtime.hints import (hint, is_dtensor, merge_heads,
                                      model_axis_size, per_shard,
                                      split_heads)

from .cache import as_adapter, supports_fused_decode, supports_fused_prefill
from .ffn import _dense
from .norms import init_rms, rms_norm
from .rope import apply_mrope, apply_rope

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
    if spec.cross_attn:
        p["c_wq"] = _dense(gen, D, H * Dh, dtype, device)
        p["c_wk"] = _dense(gen, D, Hkv * Dh, dtype, device)
        p["c_wv"] = _dense(gen, D, Hkv * Dh, dtype, device)
        p["c_wo"] = _dense(gen, H * Dh, D, dtype, device)
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
    times), and only where the heads divide a mesh's model axis (the
    context-parallel fallback keeps K/V un-repeated). On a mesh each rank
    attends its own rows and heads (``hints.per_shard``: GQA groups
    align when the query and kv heads both divide the model axis, else
    the heads are gathered). v's head dim may differ from q's and k's
    (MLA). The reference's online-softmax kv-chunk schedule for very long
    KV is not ported: every length runs the block form here."""
    if is_dtensor(q):       # on a mesh: each rank's rows and heads
        return per_shard(
            lambda q, k, v: sdpa(q, k, v, causal=causal, window=window,
                                 softcap=softcap, q_offset=q_offset,
                                 kv_valid_len=kv_valid_len, q_chunk=q_chunk),
            q, k, v, keep=(0, 2))
    B, Sq, Hq, Dh = q.shape
    rep = Sq > 1 and (Hq % model_axis_size() == 0)

    def one_chunk(qi, off):
        return _sdpa_block(qi, k, v, causal=causal, window=window,
                           softcap=softcap, q_offset=off,
                           kv_valid_len=kv_valid_len, repeat_kv=rep)

    if not q_chunk or Sq <= q_chunk or Sq % q_chunk != 0:
        return one_chunk(q, q_offset)
    outs = [one_chunk(q[:, i:i + q_chunk], q_offset + i)
            for i in range(0, Sq, q_chunk)]
    return torch.cat(outs, dim=1)


def _rope(cfg, x, positions):
    if cfg.mrope_sections is not None:
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


def attention(params, cfg, spec, x, positions, *, cache=None,
              cache_index=None, causal=True, cross_kv=None):
    """Self-attention, plus the appended cross-attention of a
    ``spec.cross_attn`` layer: ``cross_kv`` is {"enc_out": (B, Se, D)}
    (projected here) or the precomputed {"k", "v"} of ``init_cross_kv``.
    Returns (out, new_cache)."""
    S = x.shape[1]
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(qmatmul(x, params["wq"]), H, Dh)
    k = split_heads(qmatmul(x, params["wk"]), Hkv, Dh)
    v = split_heads(qmatmul(x, params["wv"]), Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if positions is not None:
        q = _rope(cfg, q, positions)
        k = _rope(cfg, k, positions)
    q, k, v = hint(q, "qkv"), hint(k, "kv"), hint(v, "kv")

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
    y = qmatmul(merge_heads(out), params["wo"])

    if spec.cross_attn:
        if cross_kv is None:
            raise ValueError("cross-attention needs the encoder's K/V")
        ckv = (init_cross_kv(params, cfg, cross_kv["enc_out"])
               if "enc_out" in cross_kv else cross_kv)
        cq = split_heads(qmatmul(x, params["c_wq"]), H, Dh)
        co = sdpa(cq, ckv["k"], ckv["v"], causal=False,
                  q_chunk=cfg.attn_q_chunk)
        y = y + qmatmul(merge_heads(co), params["c_wo"])
    return hint(y, "hidden"), new_cache


def init_cross_kv(params, cfg, enc_out) -> dict:
    """The encoder's K/V for one decoder layer, computed once (prefill)
    and reused every decode step."""
    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim
    return {"k": split_heads(qmatmul(enc_out, params["c_wk"]), Hkv, Dh),
            "v": split_heads(qmatmul(enc_out, params["c_wv"]), Hkv, Dh)}


# ------------------------------------------------------------------ MLA

def init_mla(cfg, spec, gen: torch.Generator, dtype, device) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    r, nope, ropd, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                         cfg.v_head_dim)
    return {
        "wq": _dense(gen, D, H * (nope + ropd), dtype, device),
        "wdkv": _dense(gen, D, r, dtype, device),
        "wkr": _dense(gen, D, ropd, dtype, device),
        "wukv": _dense(gen, r, H * (nope + dv), dtype, device),
        "wo": _dense(gen, H * dv, D, dtype, device),
    }


def mla_attention(params, cfg, spec, x, positions, *, cache=None,
                  cache_index=None, causal=True, cross_kv=None):
    """Multi-head latent attention (deepseek-v2). The cache holds only the
    latent {"ckv": (B, L, r)} and the shared rope key {"krope": (B, L,
    ropd)}, written in place at ``cache_index``; K and V are re-expanded
    from the whole latent on every call, as in the reference. q/k are
    ``nope + ropd`` wide, v ``v_head_dim``. Returns (out, new_cache)."""
    del cross_kv
    B, S, _ = x.shape
    H = cfg.n_heads
    r, nope, ropd, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                         cfg.v_head_dim)
    q = split_heads(qmatmul(x, params["wq"]), H, nope + ropd)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    ckv = qmatmul(x, params["wdkv"])                          # (B, S, r)
    krope = qmatmul(x, params["wkr"]).reshape(B, S, 1, ropd)
    if positions is not None:
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        krope = apply_rope(krope, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        sl = slice(cache_index, cache_index + S)
        cache["ckv"][:, sl] = ckv.to(cache["ckv"].dtype)
        cache["krope"][:, sl] = krope[:, :, 0].to(cache["krope"].dtype)
        new_cache = cache
        ckv_use, kr_use = cache["ckv"], cache["krope"][:, :, None]
        q_off, valid = cache_index, cache_index + S
    else:
        ckv_use, kr_use, q_off, valid = ckv, krope, 0, None

    L = ckv_use.shape[1]
    kv = split_heads(qmatmul(ckv_use, params["wukv"]), H, nope + dv)
    k_nope, vv = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, kr_use.expand(B, L, H, ropd).to(k_nope.dtype)],
                  dim=-1)
    qq = torch.cat([q_nope, q_rope], dim=-1)
    out = sdpa(qq, k, vv, causal=causal, window=spec.window,
               softcap=cfg.attn_softcap, q_offset=q_off, kv_valid_len=valid,
               q_chunk=cfg.attn_q_chunk)
    return hint(qmatmul(merge_heads(out), params["wo"]), "hidden"), \
        new_cache
