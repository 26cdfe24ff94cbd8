"""Decoder-only LM assembly (port of ``repro/models/transformer.py``).

Params are plain nested dicts of tensors. The reference stacks identical
layer groups and runs ``lax.scan`` over them; here ``params["layers"]`` is
a list in execution order (``cfg.layer_specs()``) and the scan is a Python
loop. A cache is a list with one entry per layer (a dense or int8 ring
dict, an MLA latent dict, or a paged-cache view from
``serving.kv_cache``).

Mixers: attention (GQA, M-RoPE, cross-attention), MLA and the state-space
mixers (``ssm.py``: mamba, rwkv6); FFNs: dense, MoE and rwkv6's channel
mix, whose parameters live in the rwkv6 mixer dict. A mamba layer's cache
is {"h", "conv"}, an rwkv6 layer's {"shift_t", "shift_c", "s"}.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.runtime.hints import (checkpoint_context_fn, gather_data,
                                      gather_inner, hint, lookup)
from repro_torch.tree import leaves

from . import attention as attn_lib
from . import ssm as ssm_lib
from .ffn import ffn, init_ffn
from .moe import init_moe, moe_ffn
from .norms import init_rms, rms_norm

_ATTN = {"attn": (attn_lib.init_attention, attn_lib.attention),
         "mla": (attn_lib.init_mla, attn_lib.mla_attention)}
_SSM_INIT = {"mamba": ssm_lib.init_mamba, "rwkv6": ssm_lib.init_rwkv6}


def init_layer(cfg, spec, gen: torch.Generator, dtype, device) -> dict:
    p = {"ln1": init_rms(cfg.d_model, dtype, device)}
    if spec.mixer in _ATTN:
        p["mixer"] = _ATTN[spec.mixer][0](cfg, spec, gen, dtype, device)
    elif spec.mixer in _SSM_INIT:
        p["mixer"] = _SSM_INIT[spec.mixer](cfg, gen, dtype, device)
    else:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    if cfg.post_block_norm:
        p["post_ln1"] = init_rms(cfg.d_model, dtype, device)
    if spec.ffn != "none":
        p["ln2"] = init_rms(cfg.d_model, dtype, device)
    if spec.ffn == "dense":
        p["ffn"] = init_ffn(cfg, gen, dtype, device)
    elif spec.ffn == "moe":
        p["ffn"] = init_moe(cfg, gen, dtype, device)
    elif spec.ffn not in ("cmix", "none"):
        raise ValueError(f"unknown ffn {spec.ffn!r}")
    if cfg.post_block_norm and spec.ffn != "none":
        p["post_ln2"] = init_rms(cfg.d_model, dtype, device)
    return p


def init_layer_cache(cfg, spec, batch: int, max_len: int, dtype,
                     device) -> dict:
    """One layer's ring cache: {"k", "v"} (B, L, Hkv, Dh) in the compute
    dtype, or int8 codes plus {"k_s", "v_s"} f32 scales (B, L, Hkv, 1)
    when ``cfg.kv_cache_dtype == "int8"``; MLA's latent {"ckv": (B, L, r),
    "krope": (B, L, ropd)}; the state-space mixers' states, which do not
    grow with L (``ssm.init_mamba_cache``, ``ssm.init_rwkv_cache``)."""
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
    if spec.mixer == "mamba":
        return ssm_lib.init_mamba_cache(cfg, batch, dtype, device)
    if spec.mixer == "rwkv6":
        return ssm_lib.init_rwkv_cache(cfg, batch, dtype, device)
    raise ValueError(f"unknown mixer {spec.mixer!r}")


def apply_layer(p, cfg, spec, x, positions, *, cache=None, cache_index=None,
                causal=True, cross_kv=None):
    h = rms_norm(x, p["ln1"])
    if spec.mixer in _ATTN:
        out, new_c = _ATTN[spec.mixer][1](
            p["mixer"], cfg, spec, h, positions, cache=cache,
            cache_index=cache_index, causal=causal, cross_kv=cross_kv)
    elif spec.mixer == "mamba":
        out, new_c = ssm_lib.mamba(p["mixer"], cfg, h, cache=cache)
    elif spec.mixer == "rwkv6":
        shift = (cache["shift_t"] if cache is not None
                 else torch.zeros_like(h[:, 0]))
        state = (cache["s"] if cache is not None
                 else ssm_lib.wkv_state(cfg, h.shape[0], h.device))
        out, new_shift, new_state = ssm_lib.rwkv6_time_mix(
            p["mixer"], cfg, h, shift_state=shift, wkv_state=state)
        new_c = (None if cache is None
                 else dict(cache, shift_t=new_shift, s=new_state))
    else:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    if cfg.post_block_norm:
        out = rms_norm(out, p["post_ln1"])
    x = x + out
    if spec.ffn != "none":
        h2 = rms_norm(x, p["ln2"])
        if spec.ffn == "cmix":
            shift_c = (cache["shift_c"] if cache is not None
                       else torch.zeros_like(h2[:, 0]))
            f, new_shift_c = ssm_lib.rwkv6_channel_mix(
                p["mixer"], cfg, h2, shift_state=shift_c)
            if new_c is not None:
                new_c = dict(new_c, shift_c=new_shift_c)
        elif spec.ffn == "moe":
            f = moe_ffn(p["ffn"], cfg, h2)
        else:
            f = ffn(p["ffn"], cfg, h2)
        if cfg.post_block_norm:
            f = rms_norm(f, p["post_ln2"])
        x = x + f
    return hint(x, "hidden"), new_c


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
    """Ring-buffer caches or SSM states, one per layer
    (``init_layer_cache``)."""
    dtype = cfg.dtype("compute")
    return [init_layer_cache(cfg, spec, batch, max_len, dtype, device)
            for spec in cfg.layer_specs()]


def _embed_in(params, cfg, batch) -> torch.Tensor:
    """Token embeddings, or the stub frontend's precomputed ``embeds``
    (B, S, D) (qwen2-vl)."""
    if "embeds" in batch:
        x = batch["embeds"].to(cfg.dtype("compute"))
    else:
        x = lookup(params["embed"], batch["tokens"].long()).to(
            cfg.dtype("compute"))
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return hint(x, "hidden")


def _lm_head(params, cfg, x) -> torch.Tensor:
    """Logits in f32 (the reference's f32 ``preferred_element_type``):
    bf16 operands upcast, so every product is exact and sums are f32."""
    x = gather_inner(rms_norm(x, params["final_norm"]))
    w = gather_data(params["embed"].T if cfg.tie_embeddings
                    else params["lm_head"])
    logits = x.float() @ w.float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return hint(logits, "logits")


def _records(x, layers) -> bool:
    """True while autograd records this forward: grad mode on and a
    layer's input or one of its weights requires grad."""
    return torch.is_grad_enabled() and (x.requires_grad or any(
        t.requires_grad for p in layers for t in leaves(p)
        if isinstance(t, torch.Tensor)))


def _dots_policy(ctx, op, *args, **kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable``: keep the
    outputs of plain matmuls (the projections), recompute the rest (the
    batched attention products among them)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, h, remat: str):
    """``fn(h)`` under activation checkpointing: ``"full"`` saves only
    ``h``, ``"dots"`` the matmul outputs too."""
    base = (functools.partial(create_selective_checkpoint_contexts,
                              _dots_policy) if remat == "dots" else None)
    context_fn = checkpoint_context_fn(base)    # a mesh's hints, if any
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(fn, h, use_reentrant=False, **kw)


def _scan_groups(params, cfg, x, positions, *, cache=None, cache_index=None,
                 train=False, causal=True, cross=None, layers_key="layers"):
    """Every layer of ``params[layers_key]`` in order (the reference's head
    layers + scanned groups). ``cross`` feeds the cross-attention layers:
    {"enc_out": (B, Se, D)} (projected in each layer) or a list of one
    precomputed {"k", "v"} per layer. Returns (x, new_cache).

    ``train`` with ``cfg.remat`` "full" or "dots" runs each scan group's
    layers (not the head layers) under one activation checkpoint, as the
    reference checkpoints its scan body; it acts only while autograd
    records, so inference and its outputs are unchanged."""
    specs, layers = cfg.layer_specs(), params[layers_key]

    def run(h, lo, hi, c=None):
        ncs = []
        for i in range(lo, hi):
            ckv = None
            if specs[i].cross_attn and cross is not None:
                ckv = cross if isinstance(cross, dict) else cross[i]
            h, nc = apply_layer(layers[i], cfg, specs[i], h, positions,
                                cache=None if c is None else c[i],
                                cache_index=cache_index, causal=causal,
                                cross_kv=ckv)
            ncs.append(nc)
        return h, ncs

    if not (train and cfg.remat in ("full", "dots") and cache is None
            and _records(x, layers)):
        x, new_cache = run(x, 0, len(specs), cache)
        return x, (new_cache if cache is not None else None)
    n_head, glen = len(cfg.head_layers), len(cfg.group)
    x, _ = run(x, 0, n_head)
    for lo in range(n_head, len(specs), glen):
        x = _remat(lambda h, lo=lo: run(h, lo, lo + glen)[0], x, cfg.remat)
    return x, None


def _default_positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return torch.arange(S, dtype=torch.int32,
                        device=x.device)[None].expand(B, S)


def lm_forward(params, cfg, batch, *, train=True, return_hidden=False):
    """Full-sequence forward -> logits (B, S, V) f32 (or the pre-head
    hidden with ``return_hidden``: the chunked loss applies the head per
    sequence chunk). ``train``: remat per ``cfg.remat`` while autograd
    records (``_scan_groups``)."""
    x = _embed_in(params, cfg, batch)
    positions = batch.get("positions")
    if positions is None:
        positions = _default_positions(x)
    x, _ = _scan_groups(params, cfg, x, positions, train=train)
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
