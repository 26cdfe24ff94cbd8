"""Model facade (port of ``repro/models/__init__.py``, LM family)."""
from __future__ import annotations

import torch

from . import transformer as _tf
from .convert import params_from_reference


def _check_lm(cfg) -> None:
    if cfg.family != "lm":
        raise ValueError(f"the port serves decoder-only LMs, got "
                         f"{cfg.family!r}")


def init_params(cfg, gen: torch.Generator, device) -> dict:
    _check_lm(cfg)
    return _tf.init_lm(cfg, gen, device)


def forward(params, cfg, batch, *, return_hidden=False):
    _check_lm(cfg)
    return _tf.lm_forward(params, cfg, batch, return_hidden=return_hidden)


def init_cache(cfg, batch_size: int, max_len: int, device):
    _check_lm(cfg)
    return _tf.init_lm_cache(cfg, batch_size, max_len, device)


def prefill(params, cfg, batch, cache):
    _check_lm(cfg)
    return _tf.lm_prefill(params, cfg, batch, cache)


def decode_step(params, cfg, tokens, cache, cache_index):
    _check_lm(cfg)
    return _tf.lm_decode_step(params, cfg, tokens, cache, cache_index)


__all__ = ["init_params", "forward", "init_cache", "prefill", "decode_step",
           "params_from_reference"]
