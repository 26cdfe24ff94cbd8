"""Decoder-only LM assembly (port of ``repro/models/transformer.py``).

Params are plain nested dicts of tensors. The reference stacks identical
layer groups and runs ``lax.scan`` over them; here ``params["layers"]`` is
a list in execution order (``cfg.layer_specs()``) and the scan is a Python
loop. A cache is a list with one entry per layer (a dense or int8 ring
dict, an MLA latent dict, or a paged-cache view from
``serving.kv_cache``).

Mixers: attention (GQA, M-RoPE, cross-attention) and MLA; FFNs: dense and
MoE. The state-space mixers (mamba, rwkv6 and its channel mix) are the
next slice of the port and raise here.
"""
from __future__ import annotations

import math

import torch

from . import attention as attn_lib
from .ffn import ffn, init_ffn
from .moe import init_moe, moe_ffn
from .norms import init_rms, rms_norm

_MIXERS = {"attn": (attn_lib.init_attention, attn_lib.attention),
           "mla": (attn_lib.init_mla, attn_lib.mla_attention)}
_NEXT_SLICE = ("mamba", "rwkv6", "cmix")


def _refuse(kind: str, name: str):
    if name in _NEXT_SLICE:
        raise ValueError(f"{kind} {name!r} belongs to the state-space "
                         f"family (models/ssm.py), not ported yet")
    raise ValueError(f"unknown {kind} {name!r}")


def init_layer(cfg, spec, gen: torch.Generator, dtype, device) -> dict:
    if spec.mixer not in _MIXERS:
        _refuse("mixer", spec.mixer)
    p = {"ln1": init_rms(cfg.d_model, dtype, device),
         "mixer": _MIXERS[spec.mixer][0](cfg, spec, gen, dtype, device)}
    if cfg.post_block_norm:
        p["post_ln1"] = init_rms(cfg.d_model, dtype, device)
    if spec.ffn == "dense":
        p["ln2"] = init_rms(cfg.d_model, dtype, device)
        p["ffn"] = init_ffn(cfg, gen, dtype, device)
    elif spec.ffn == "moe":
        p["ln2"] = init_rms(cfg.d_model, dtype, device)
        p["ffn"] = init_moe(cfg, gen, dtype, device)
    elif spec.ffn != "none":
        _refuse("ffn", spec.ffn)
    if cfg.post_block_norm and spec.ffn != "none":
        p["post_ln2"] = init_rms(cfg.d_model, dtype, device)
    return p


def init_layer_cache(cfg, spec, batch: int, max_len: int, dtype,
                     device) -> dict:
    """One layer's ring cache: {"k", "v"} (B, L, Hkv, Dh) in the compute
    dtype, or int8 codes plus {"k_s", "v_s"} f32 scales (B, L, Hkv, 1)
    when ``cfg.kv_cache_dtype == "int8"``; MLA's latent {"ckv": (B, L, r),
    "krope": (B, L, ropd)}."""
    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    if spec.mixer == "attn":
        kv = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        if cfg.kv_cache_dtype == "int8":
            sc = (batch, max_len, cfg.n_kv_heads, 1)
            return {"k": zeros(kv, torch.int8), "v": zeros(kv, torch.int8),
                    "k_s": zeros(sc, torch.float32),
                    "v_s": zeros(sc, torch.float32)}
        return {"k": zeros(kv, dtype), "v": zeros(kv, dtype)}
    if spec.mixer == "mla":
        return {"ckv": zeros((batch, max_len, cfg.kv_lora_rank), dtype),
                "krope": zeros((batch, max_len, cfg.qk_rope_dim), dtype)}
    _refuse("mixer", spec.mixer)


def apply_layer(p, cfg, spec, x, positions, *, cache=None, cache_index=None,
                causal=True, cross_kv=None):
    h = rms_norm(x, p["ln1"])
    if spec.mixer not in _MIXERS:
        _refuse("mixer", spec.mixer)
    out, new_c = _MIXERS[spec.mixer][1](
        p["mixer"], cfg, spec, h, positions, cache=cache,
        cache_index=cache_index, causal=causal, cross_kv=cross_kv)
    if cfg.post_block_norm:
        out = rms_norm(out, p["post_ln1"])
    x = x + out
    if spec.ffn != "none":
        h2 = rms_norm(x, p["ln2"])
        f = moe_ffn(p["ffn"], cfg, h2) if spec.ffn == "moe" else ffn(
            p["ffn"], cfg, h2)
        if cfg.post_block_norm:
            f = rms_norm(f, p["post_ln2"])
        x = x + f
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
    """Ring-buffer caches, one per layer (``init_layer_cache``)."""
    dtype = cfg.dtype("compute")
    return [init_layer_cache(cfg, spec, batch, max_len, dtype, device)
            for spec in cfg.layer_specs()]


def _embed_in(params, cfg, batch) -> torch.Tensor:
    """Token embeddings, or the stub frontend's precomputed ``embeds``
    (B, S, D) (qwen2-vl)."""
    if "embeds" in batch:
        x = batch["embeds"].to(cfg.dtype("compute"))
    else:
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
                 causal=True, cross=None, layers_key="layers"):
    """Every layer of ``params[layers_key]`` in order (the reference's head
    layers + scanned groups). ``cross`` feeds the cross-attention layers:
    {"enc_out": (B, Se, D)} (projected in each layer) or a list of one
    precomputed {"k", "v"} per layer. Returns (x, new_cache)."""
    new_cache = [] if cache is not None else None
    for i, spec in enumerate(cfg.layer_specs()):
        c = None if cache is None else cache[i]
        ckv = None
        if spec.cross_attn and cross is not None:
            ckv = cross if isinstance(cross, dict) else cross[i]
        x, nc = apply_layer(params[layers_key][i], cfg, spec, x, positions,
                            cache=c, cache_index=cache_index, causal=causal,
                            cross_kv=ckv)
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
    per-sequence lengths (continuous batching over a paged cache). The
    W = 1 case of ``lm_decode_window``."""
    return lm_decode_window(params, cfg, tokens, cache, cache_index)


def lm_decode_window(params, cfg, tokens, cache, cache_index):
    """Multi-token decode window: tokens (B, W) continue every sequence at
    its own offset -> (logits (B, W, V), new_cache).

    The speculative verify pass: position w of row b is scored at
    ``cache_index[b] + w``, causal inside the window, so one batched pass
    gives the model's next-token logits after each of the W prefixes, the
    same math as W sequential decode steps."""
    x = _embed_in(params, cfg, {"tokens": tokens})
    B, W = tokens.shape
    if isinstance(cache_index, torch.Tensor):
        base = cache_index.to(device=x.device, dtype=torch.int32).reshape(
            B, 1)
    else:
        base = torch.full((B, 1), int(cache_index), dtype=torch.int32,
                          device=x.device)
    positions = base + torch.arange(W, dtype=torch.int32, device=x.device)
    if cfg.mrope_sections is not None:      # text: one index, three streams
        positions = positions[None].expand(3, B, W)
    x, new_cache = _scan_groups(params, cfg, x, positions, cache=cache,
                                cache_index=cache_index)
    return _lm_head(params, cfg, x), new_cache
