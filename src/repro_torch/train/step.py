"""The train step (port of ``repro/train/step.py``) on one device.

``input_specs`` gives every model input of a cell as a (shape, dtype)
pair; ``lm_loss`` is next-token CE + z-loss over sequence chunks;
``make_train_step`` returns ``(train_step, opt)``, where ``train_step(state,
batch)`` takes state ``{"params", "opt", "step"}`` and returns ``(new_state,
metrics)``: value and grad by autograd, an optional ``grad_compress``,
clipping by the global norm, then the optimizer. The reference's step
builders that need a mesh (``make_prefill_step``, ``make_decode_step``,
``opt_state_shardings``, ``train_state_specs``, ``cache_specs``) come
with the port of ``runtime/sharding.py``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import models
from repro_torch.optim import for_config
from repro_torch.tree import leaves, tree_map, unflatten

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}
WHISPER_ENC_LEN = 1504   # whisper's 30 s window (1500 frames, padded)


def shape_skip_reason(cfg, shape_name: str) -> str | None:
    """Cells skipped by design: a 512k decode needs sub-quadratic
    attention."""
    if shape_name == "long_500k" and not cfg.subquadratic:
        return ("full-attention arch: 512k decode needs sub-quadratic "
                "attention (DESIGN.md §4)")
    return None


def input_specs(cfg, shape_name: str, *, batch: int | None = None,
                seq: int | None = None) -> dict:
    """name -> (shape, dtype) for every model input of the cell
    (``batch``/``seq`` override the cell's)."""
    info = SHAPES[shape_name]
    B, S = batch or info["batch"], seq or info["seq"]
    i32, f = torch.int32, cfg.dtype("compute")
    specs = {}
    if info["kind"] in ("train", "prefill"):
        if cfg.family == "encdec":
            specs["enc_embeds"] = ((B, S, cfg.d_model), f)
            specs["tokens"] = ((B, S), i32)
        elif cfg.input_kind == "embeds":
            specs["embeds"] = ((B, S, cfg.d_model), f)
            if cfg.mrope_sections is not None:
                specs["positions"] = ((3, B, S), i32)
        else:
            specs["tokens"] = ((B, S), i32)
        if info["kind"] == "train":
            specs["labels"] = ((B, S), i32)
    else:  # decode: one new token against a seq-long cache
        specs["tokens"] = ((B, 1), i32)
    return specs


def lm_loss(params, cfg, batch, *, train=True, loss_chunk: int = 512):
    """Next-token CE + 1e-4 z-loss -> (loss, {"ce", "zloss"}).

    The head and the softmax run per sequence chunk of ``loss_chunk``
    under activation checkpointing, so the live f32 logits are (B, chunk,
    V), not (B, S, V); the chunks' sums add in order, as the reference's
    scan."""
    x = models.forward(params, cfg, batch, train=train, return_hidden=True)
    B, S, _ = x.shape
    labels = batch["labels"].long()

    def chunk_loss(xc, lc):
        logits = models.lm_head(params, cfg, xc).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, lc[..., None])[..., 0]
        return torch.sum(lse - picked), torch.sum(lse ** 2)

    if S % loss_chunk == 0 and S > loss_chunk:
        ce_sum = z_sum = torch.zeros((), dtype=torch.float32,
                                     device=x.device)
        for lo in range(0, S, loss_chunk):
            sl = slice(lo, lo + loss_chunk)
            ce, z = checkpoint(chunk_loss, x[:, sl], labels[:, sl],
                               use_reentrant=False)
            ce_sum, z_sum = ce_sum + ce, z_sum + z
    else:
        ce_sum, z_sum = chunk_loss(x, labels)
    n = B * S
    loss = ce_sum / n
    zl = 1e-4 * z_sum / n
    return loss + zl, {"ce": loss, "zloss": zl}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))


def make_train_step(cfg, *, lr: float = 3e-4, clip_norm: float = 1.0,
                    grad_compress=None):
    """Returns ``(train_step, opt)``. grad_compress: optional
    ``fn(grads) -> grads`` applied before clipping."""
    opt = for_config(cfg)

    def train_step(state, batch):
        params = tree_map(lambda t: t.detach().requires_grad_(),
                          state["params"])
        loss, metrics = lm_loss(params, cfg, batch)
        flat = leaves(params)
        grads = unflatten(params, [
            torch.zeros_like(t) if g is None else g for t, g in
            zip(flat, torch.autograd.grad(loss, flat, allow_unused=True))])
        with torch.no_grad():
            if grad_compress is not None:
                grads = grad_compress(grads)
            gn = global_norm(grads)
            scale = torch.clamp(clip_norm / torch.clamp(gn, min=1e-9),
                                max=1.0)
        # each grad times scale in f32 (the reference's clipped grads),
        # one leaf at a time inside the update
        new_params, opt_state = opt.update(grads, state["opt"],
                                           state["params"], lr=lr,
                                           grad_scale=scale)
        metrics = dict({k: v.detach() for k, v in metrics.items()},
                       loss=loss.detach(), grad_norm=gn)
        return {"params": new_params, "opt": opt_state,
                "step": state["step"] + 1}, metrics

    return train_step, opt
