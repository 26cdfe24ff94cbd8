"""The static serve path's steps (port of ``repro/launch/static_steps.py``):
one fixed batch of equal-length prompts prefilled into the model's dense
ring cache (``models.init_cache``), then greedy decode steps, every row at
the same position. An encoder-decoder model (whisper) takes its encoder's
input ``enc`` (B, S_enc, D) beside the prompts. No paged pool and no hand-written kernel: the
projections run as dense matmuls (``--quantize`` weights are dequantized
first, as in the reference).

The port's steps also return the logits row each token was taken from,
so a caller can hold the path against another engine's logits.
"""
from __future__ import annotations

import torch


def static_prefill(params, cfg, tokens: torch.Tensor, gen_len: int,
                   enc: torch.Tensor | None = None):
    """Prefill ``tokens`` (B, P) (and, encdec, encode ``enc``) into a ring
    cache sized for ``gen_len`` further decode steps; returns (the first
    greedy tokens (B, 1) int32, the cache, the last position's logits
    (B, V) f32)."""
    from repro_torch import models

    B, P = tokens.shape
    cache = models.init_cache(cfg, B, P + gen_len, tokens.device,
                              enc_len=P)
    batch = {"tokens": tokens}
    if enc is not None:
        batch["enc_embeds"] = enc
    logits, cache = models.prefill(params, cfg, batch, cache)
    last = logits[:, -1]
    return last.argmax(-1).to(torch.int32)[:, None], cache, last


def static_decode_step(params, cfg, tok: torch.Tensor, cache, idx: int):
    """One greedy decode step at ring-cache position ``idx``; returns (the
    next tokens (B, 1) int32, the cache, their logits (B, V) f32)."""
    from repro_torch import models

    logits, cache = models.decode_step(params, cfg, tok, cache, idx)
    last = logits[:, -1]
    return last.argmax(-1).to(torch.int32)[:, None], cache, last


@torch.inference_mode()
def static_generate(params, cfg, tokens: torch.Tensor, gen_len: int,
                    enc: torch.Tensor | None = None):
    """``gen_len`` greedy tokens for every prompt of ``tokens`` (B, P):
    one prefill, then ``gen_len - 1`` decode steps. Returns (tokens (B,
    gen_len) int32, logits (B, gen_len, V) f32), on ``tokens``' device."""
    P = tokens.shape[1]
    tok, cache, last = static_prefill(params, cfg, tokens, gen_len, enc)
    toks, rows = [tok], [last]
    for i in range(gen_len - 1):
        tok, cache, last = static_decode_step(params, cfg, tok, cache, P + i)
        toks.append(tok)
        rows.append(last)
    return torch.cat(toks, dim=1), torch.stack(rows, dim=1)
