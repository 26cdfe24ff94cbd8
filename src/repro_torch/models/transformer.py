"""Decoder-only LM assembly (port of ``repro/models/transformer.py``).

Params are plain nested dicts of tensors. The reference stacks identical
layer groups and runs ``lax.scan`` over them; here ``params["layers"]`` is
a list in execution order (``cfg.layer_specs()``) and the scan is a Python
loop. A cache is a list with one entry per layer (a dense ring dict, or a
paged-cache view from ``serving.kv_cache``).
"""
from __future__ import annotations

import math

import torch

from . import attention as attn_lib
from .ffn import ffn, init_ffn
from .norms import init_rms, rms_norm


def init_layer(cfg, spec, gen: torch.Generator, dtype, device) -> dict:
    if spec.mixer != "attn":
        raise ValueError(f"the port serves attention mixers only, got "
                         f"{spec.mixer!r}")
    p = {"ln1": init_rms(cfg.d_model, dtype, device),
         "mixer": attn_lib.init_attention(cfg, spec, gen, dtype, device)}
    if spec.ffn == "dense":
        p["ln2"] = init_rms(cfg.d_model, dtype, device)
        p["ffn"] = init_ffn(cfg, gen, dtype, device)
    elif spec.ffn != "none":
        raise ValueError(f"the port serves dense FFNs only, got {spec.ffn!r}")
    return p


def apply_layer(p, cfg, spec, x, positions, *, cache=None, cache_index=None,
                causal=True):
    h = rms_norm(x, p["ln1"])
    out, new_c = attn_lib.attention(p["mixer"], cfg, spec, h, positions,
                                    cache=cache, cache_index=cache_index,
                                    causal=causal)
    x = x + out
    if spec.ffn != "none":
        x = x + ffn(p["ffn"], cfg, rms_norm(x, p["ln2"]))
    return x, new_c


def init_lm(cfg, gen: torch.Generator, device) -> dict:
    """Seeded random weights. ``gen`` must live on ``device``; torch and
    jax draw different numbers from one seed, so parity tests convert the
    reference's params instead (``models.params_from_reference``)."""
    dtype = cfg.dtype("param")
    params = {
        "embed": torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                             dtype=torch.float32, device=device).to(dtype),
        "final_norm": init_rms(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = (torch.randn(
            (cfg.d_model, cfg.vocab), generator=gen, dtype=torch.float32,
            device=device) / math.sqrt(cfg.d_model)).to(dtype)
    params["layers"] = [init_layer(cfg, spec, gen, dtype, device)
                        for spec in cfg.layer_specs()]
    return params


def init_lm_cache(cfg, batch: int, max_len: int, device) -> list[dict]:
    """Dense ring-buffer caches, one per layer."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dtype = cfg.dtype("compute")
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in cfg.layer_specs()]


def _embed_in(params, cfg, batch) -> torch.Tensor:
    x = params["embed"][batch["tokens"].long()].to(cfg.dtype("compute"))
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def _lm_head(params, cfg, x) -> torch.Tensor:
    """Logits in f32 (the reference's f32 ``preferred_element_type``):
    bf16 operands upcast, so every product is exact and sums are f32."""
    x = rms_norm(x, params["final_norm"])
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x.float() @ w.float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _scan_groups(params, cfg, x, positions, *, cache=None, cache_index=None,
                 causal=True):
    """Every layer in order (the reference's head layers + scanned groups).
    Returns (x, new_cache)."""
    new_cache = [] if cache is not None else None
    for i, spec in enumerate(cfg.layer_specs()):
        c = None if cache is None else cache[i]
        x, nc = apply_layer(params["layers"][i], cfg, spec, x, positions,
                            cache=c, cache_index=cache_index, causal=causal)
        if cache is not None:
            new_cache.append(nc)
    return x, new_cache


def _default_positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return torch.arange(S, dtype=torch.int32,
                        device=x.device)[None].expand(B, S)


def lm_forward(params, cfg, batch, *, return_hidden=False):
    """Full-sequence forward -> logits (B, S, V) f32."""
    x = _embed_in(params, cfg, batch)
    positions = batch.get("positions")
    if positions is None:
        positions = _default_positions(x)
    x, _ = _scan_groups(params, cfg, x, positions)
    return x if return_hidden else _lm_head(params, cfg, x)


def lm_prefill(params, cfg, batch, cache):
    """Populate the cache from a prompt (or a chunk of one, with explicit
    ``batch["positions"]``); returns (logits, cache)."""
    x = _embed_in(params, cfg, batch)
    positions = batch.get("positions")
    if positions is None:
        positions = _default_positions(x)
    x, new_cache = _scan_groups(params, cfg, x, positions, cache=cache,
                                cache_index=0)
    return _lm_head(params, cfg, x), new_cache


def lm_decode_step(params, cfg, tokens, cache, cache_index):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), new_cache).

    cache_index is an int (every row at one length) or a (B,) tensor of
    per-sequence lengths (continuous batching over a paged cache)."""
    x = _embed_in(params, cfg, {"tokens": tokens})
    B, W = tokens.shape
    if isinstance(cache_index, torch.Tensor):
        base = cache_index.to(device=x.device, dtype=torch.int32).reshape(
            B, 1)
    else:
        base = torch.full((B, 1), int(cache_index), dtype=torch.int32,
                          device=x.device)
    positions = base + torch.arange(W, dtype=torch.int32, device=x.device)
    x, new_cache = _scan_groups(params, cfg, x, positions, cache=cache,
                                cache_index=cache_index)
    return _lm_head(params, cfg, x), new_cache
