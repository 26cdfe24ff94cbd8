"""Model facade (port of ``repro/models/__init__.py``): one interface over
the decoder-only LM family and the encoder-decoder one (whisper)."""
from __future__ import annotations

import torch

from . import encdec as _ed
from . import transformer as _tf
from .convert import (mlp_params_from_reference, opt_state_from_reference,
                      params_from_reference)


def init_params(cfg, gen: torch.Generator, device) -> dict:
    if cfg.family == "encdec":
        return _ed.init_encdec(cfg, gen, device)
    return _tf.init_lm(cfg, gen, device)


def forward(params, cfg, batch, *, train=True, return_hidden=False):
    """Logits (or the pre-head hidden). ``train`` (the reference's
    default) remats the layer groups per ``cfg.remat``, only while
    autograd records."""
    if cfg.family == "encdec":
        return _ed.encdec_forward(params, cfg, batch, train=train,
                                  return_hidden=return_hidden)
    return _tf.lm_forward(params, cfg, batch, train=train,
                          return_hidden=return_hidden)


def lm_head(params, cfg, hidden):
    return _tf._lm_head(params, cfg, hidden)


def init_cache(cfg, batch_size: int, max_len: int, device, *,
               enc_len: int | None = None):
    if cfg.family == "encdec":
        return _ed.init_encdec_cache(cfg, batch_size, max_len,
                                     enc_len or max_len, device)
    return _tf.init_lm_cache(cfg, batch_size, max_len, device)


def prefill(params, cfg, batch, cache):
    if cfg.family == "encdec":
        return _ed.encdec_prefill(params, cfg, batch, cache)
    return _tf.lm_prefill(params, cfg, batch, cache)


def decode_step(params, cfg, tokens, cache, cache_index):
    if cfg.family == "encdec":
        return _ed.encdec_decode_step(params, cfg, tokens, cache,
                                      cache_index)
    return _tf.lm_decode_step(params, cfg, tokens, cache, cache_index)


def decode_window(params, cfg, tokens, cache, cache_index):
    """Multi-token decode window (B, W) at per-sequence offsets: the
    speculative verify pass (LM family only)."""
    if cfg.family != "lm":
        raise ValueError(f"decode_window drives decoder-only LMs, got "
                         f"{cfg.family!r}")
    return _tf.lm_decode_window(params, cfg, tokens, cache, cache_index)


def param_count(params) -> int:
    """Elements of every leaf of ``params`` (a QuantizedTensor counts its
    codebook and its codes, as the reference's pytree leaves)."""
    from repro_torch.core.types import QuantizedTensor
    from repro_torch.tree import leaves

    return sum(p.codebook.numel() + p.indices.numel()
               if isinstance(p, QuantizedTensor) else p.numel()
               for p in leaves(params))


__all__ = ["init_params", "param_count", "forward", "lm_head", "init_cache",
           "prefill",
           "decode_step", "decode_window", "params_from_reference",
           "opt_state_from_reference", "mlp_params_from_reference"]
