"""Encoder-decoder model, the whisper-tiny backbone (port of
``repro/models/encdec.py``).

The conv/mel frontend is a stub: the encoder takes precomputed frame
embeddings (B, S_enc, d_model) and runs bidirectional attention. The
decoder is the causal stack with per-layer cross-attention. Its cache is
{"self": one ring dict per decoder layer, "cross": one {"k", "v"} of the
encoder's keys and values per decoder layer, computed once at prefill}
(the reference's vmap over stacked groups, unrolled into the port's list).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import LayerSpec

from . import attention as attn_lib
from .norms import init_rms, rms_norm
from .transformer import (_default_positions, _embed_in, _lm_head,
                          _scan_groups, init_layer, init_lm, init_lm_cache)


def _enc_cfg(cfg):
    """The encoder's config: the decoder's widths with its own (attention,
    dense FFN, no cross) layer pattern and depth."""
    return dataclasses.replace(
        cfg, group=(LayerSpec(mixer="attn", ffn="dense"),), head_layers=(),
        n_layers=cfg.n_enc_layers)


def init_encdec(cfg, gen: torch.Generator, device) -> dict:
    params = init_lm(cfg, gen, device)          # decoder + embed + head
    ecfg, dtype = _enc_cfg(cfg), cfg.dtype("param")
    params["enc_layers"] = [init_layer(ecfg, spec, gen, dtype, device)
                            for spec in ecfg.layer_specs()]
    params["enc_norm"] = init_rms(cfg.d_model, dtype, device)
    return params


def encode(params, cfg, enc_embeds: torch.Tensor) -> torch.Tensor:
    x = enc_embeds.to(cfg.dtype("compute"))
    x, _ = _scan_groups(params, _enc_cfg(cfg), x, _default_positions(x),
                        causal=not cfg.enc_bidirectional,
                        layers_key="enc_layers")
    return rms_norm(x, params["enc_norm"])


def encdec_forward(params, cfg, batch, *, train=True, return_hidden=False):
    """batch: enc_embeds (B, Se, D), tokens (B, Sd) -> logits (B, Sd, V).
    ``train`` remats the decoder's groups (not the encoder's), as the
    reference."""
    enc_out = encode(params, cfg, batch["enc_embeds"])
    x = _embed_in(params, cfg, {"tokens": batch["tokens"]})
    x, _ = _scan_groups(params, cfg, x, _default_positions(x), train=train,
                        cross={"enc_out": enc_out})
    return x if return_hidden else _lm_head(params, cfg, x)


def init_encdec_cache(cfg, batch: int, max_len: int, enc_len: int,
                      device) -> dict:
    dtype = cfg.dtype("compute")
    kv = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
    return {"self": init_lm_cache(cfg, batch, max_len, device),
            "cross": [{"k": torch.zeros(kv, dtype=dtype, device=device),
                       "v": torch.zeros(kv, dtype=dtype, device=device)}
                      for _ in cfg.layer_specs()]}


def encdec_prefill(params, cfg, batch, cache):
    """Encode, then prefill the decoder: fills the self K/V and the cross
    K/V. Returns (logits, cache)."""
    enc_out = encode(params, cfg, batch["enc_embeds"])
    cross = [attn_lib.init_cross_kv(p["mixer"], cfg, enc_out)
             for p in params["layers"]]
    x = _embed_in(params, cfg, {"tokens": batch["tokens"]})
    x, self_cache = _scan_groups(params, cfg, x, _default_positions(x),
                                 cache=cache["self"], cache_index=0,
                                 cross=cross)
    return _lm_head(params, cfg, x), {"self": self_cache, "cross": cross}


def encdec_decode_step(params, cfg, tokens, cache, cache_index: int):
    x = _embed_in(params, cfg, {"tokens": tokens})
    positions = torch.full((x.shape[0], 1), int(cache_index),
                           dtype=torch.int32, device=x.device)
    x, self_cache = _scan_groups(params, cfg, x, positions,
                                 cache=cache["self"], cache_index=cache_index,
                                 cross=cache["cross"])
    return _lm_head(params, cfg, x), {"self": self_cache,
                                      "cross": cache["cross"]}
