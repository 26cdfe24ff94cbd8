"""Step builders: train, prefill and decode, on one device or a mesh
(port of ``repro/train/step.py``).

``input_specs`` gives every model input of a cell as a (shape, dtype)
pair; ``lm_loss`` is next-token CE + z-loss over sequence chunks;
``make_train_step(cfg, mesh=None)`` returns ``(train_step, opt)``, where
``train_step(state, batch)`` takes state ``{"params", "opt", "step"}`` and
returns ``(new_state, metrics)``: value and grad by autograd, an optional
``grad_compress``, clipping by the global norm, then the optimizer.

With a mesh (a ``DeviceMesh`` with dims ``("data", "model")``), the state
and batch are DTensors placed by ``runtime.sharding`` (``train_state_specs``,
``distribute_batch``) and the step runs under ``hint_context(mesh,
hint_specs(cfg, mesh))`` and DTensor's implicit replication, which treats
the plain tensors the models make inside (positions, masks) as
replicated. The arithmetic is the one-device step's; only the order of
the sums that cross shards differs. Metrics come back as full tensors,
the same on every rank.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import models
from repro_torch.optim import for_config, stack_layers
from repro_torch.runtime.hints import checkpoint_context_fn, hint_context
from repro_torch.runtime.sharding import (batch_shardings, cache_shardings,
                                          distribute, hint_specs,
                                          param_shardings, param_specs,
                                          placements)
from repro_torch.tree import items, leaves, tree_map, unflatten

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
        logits = _whole_vocab(models.lm_head(params, cfg, xc).to(
            torch.float32))
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, lc[..., None])[..., 0]
        return torch.sum(lse - picked), torch.sum(lse ** 2)

    if S % loss_chunk == 0 and S > loss_chunk:
        context_fn = checkpoint_context_fn()     # a mesh's hints, if any
        kw = {} if context_fn is None else {"context_fn": context_fn}
        ce_sum = z_sum = torch.zeros((), dtype=torch.float32,
                                     device=x.device)
        for lo in range(0, S, loss_chunk):
            sl = slice(lo, lo + loss_chunk)
            ce, z = checkpoint(chunk_loss, x[:, sl], labels[:, sl],
                               use_reentrant=False, **kw)
            ce_sum, z_sum = ce_sum + ce, z_sum + z
    else:
        ce_sum, z_sum = chunk_loss(x, labels)
    n = B * S
    loss = ce_sum / n
    zl = 1e-4 * z_sum / n
    return loss + zl, {"ce": loss, "zloss": zl}


def _whole_vocab(logits):
    """A DTensor's logits with the vocab dim gathered (its batch and
    sequence shards kept): DTensor's ``gather`` over a vocab-sharded
    tensor (the ``"logits"`` hint shards vocab over ``model``) fails in
    its masked-partial path, and with the whole row on each rank the
    logsumexp and the pick are the one-device ops on that row."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(logits, DTensor):
        return logits
    last = logits.ndim - 1
    pl = [Replicate() if p.is_shard(last) else p for p in logits.placements]
    return logits.redistribute(logits.device_mesh, pl)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))


def on_mesh(cfg, mesh):
    """The context a sharded step runs in: the config's activation hints
    on ``mesh`` and DTensor's implicit replication (nothing on one
    device, ``mesh=None``)."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    stack = contextlib.ExitStack()
    stack.enter_context(hint_context(mesh, hint_specs(cfg, mesh)))
    stack.enter_context(implicit_replication())
    return stack


def placed_as(t, like):
    """``t`` redistributed to ``like``'s placements (a partial sum
    reduced): a sharded step's grads take their params' shardings, as
    the reference's jit gives them."""
    return t.redistribute(like.device_mesh, like.placements)


def _full(t):
    """A DTensor as its full tensor (the same on every rank); a plain
    tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def value_and_grad(params, cfg, batch):
    """(loss, metrics, grads) of ``lm_loss`` by autograd; an unused
    param's grad is zeros."""
    params = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = lm_loss(params, cfg, batch)
    flat = leaves(params)
    grads = unflatten(params, [
        torch.zeros_like(t) if g is None else g for t, g in
        zip(flat, torch.autograd.grad(loss, flat, allow_unused=True))])
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg, mesh=None, *, lr: float = 3e-4,
                    clip_norm: float = 1.0, grad_compress=None):
    """Returns ``(train_step, opt)``. grad_compress: optional
    ``fn(grads) -> grads`` applied before clipping. ``mesh``: run on a
    device mesh (module docstring); ``None`` is the one-device step."""
    opt = for_config(cfg)

    def train_step(state, batch):
        with on_mesh(cfg, mesh):
            loss, metrics, grads = value_and_grad(state["params"], cfg,
                                                  batch)
            if mesh is not None:     # each grad placed as its param
                grads = tree_map(placed_as, grads, state["params"])
            with torch.no_grad():
                if grad_compress is not None:
                    grads = grad_compress(grads)
                gn = global_norm(grads)
                scale = torch.clamp(clip_norm / torch.clamp(gn, min=1e-9),
                                    max=1.0)
            # each grad times scale in f32 (the reference's clipped
            # grads), one leaf at a time inside the update
            new_params, opt_state = opt.update(grads, state["opt"],
                                               state["params"], lr=lr,
                                               grad_scale=scale)
            metrics = {k: _full(v) for k, v in
                       dict(metrics, loss=loss, grad_norm=gn).items()}
        return {"params": new_params, "opt": opt_state,
                "step": state["step"] + 1}, metrics

    return train_step, opt


def _cell(shape_name, batch, seq):
    info = SHAPES[shape_name]
    return batch or info["batch"], seq or info["seq"]


def make_prefill_step(cfg, mesh, shape_name: str, *, batch: int | None = None,
                      seq: int | None = None, device=None):
    """``prefill_step(params, inputs) -> (last-position logits, cache)``:
    the cache of the cell's (batch, seq) (``batch``/``seq`` override it)
    is made inside the step on ``device`` (default: the params'), placed
    by ``cache_shardings`` on a mesh, then filled."""
    B, S = _cell(shape_name, batch, seq)

    def prefill_step(params, inputs):
        dev = device or leaves(params)[0].device
        enc_len = WHISPER_ENC_LEN if cfg.family == "encdec" else None
        cache = models.init_cache(cfg, B, S, dev, enc_len=enc_len)
        if mesh is not None:
            cache = distribute(cache, mesh, cache_shardings(
                mesh, cfg, cache, batch_size=B))
        with on_mesh(cfg, mesh):
            logits, cache = models.prefill(params, cfg, inputs, cache)
            return logits[:, -1], cache

    return prefill_step


def make_decode_step(cfg, mesh, shape_name: str, *, seq: int | None = None):
    """``decode_step(params, tokens, cache) -> (next tokens (B, 1),
    cache)``: one token against a ``seq``-long cache (the cell's by
    default), written in place at ``seq - 1``; greedy."""
    _, S = _cell(shape_name, None, seq)
    cache_index = S - 1

    def decode_step(params, tokens, cache):
        with on_mesh(cfg, mesh):
            logits, new_cache = models.decode_step(params, cfg, tokens,
                                                   cache, cache_index)
            next_tok = torch.argmax(_full(logits)[:, -1], dim=-1)
        return next_tok.to(torch.int32)[:, None], new_cache

    return decode_step


# ---------------------------------------------------------------- shardings


def cache_specs(cfg, shape_name: str, *, batch: int | None = None,
                seq: int | None = None):
    """The cell's cache as meta tensors (shapes and dtypes only)."""
    B, S = _cell(shape_name, batch, seq)
    enc_len = WHISPER_ENC_LEN if cfg.family == "encdec" else None
    return models.init_cache(cfg, B, S, torch.device("meta"),
                             enc_len=enc_len)


def opt_state_specs(mesh, param_spec_tree, opt_state) -> dict:
    """Specs of an optimizer state (the reference's stacked layout) from
    the params' specs in that layout (``param_specs(mesh,
    stack_layers(params, cfg))``): the moments mirror their param,
    Adafactor's ``vr``/``vc`` drop the factored dim's entry, scalars
    replicate."""
    flat = {tuple(p.split("/")): s for p, s in items(param_spec_tree)}

    def per_leaf(path, leaf):
        names = tuple(path.split("/"))
        if names[-1] == "count" or leaf.ndim == 0:
            return ()
        sub = names[1:]  # drop leading "m"/"v"
        if sub in flat:
            return flat[sub]
        if names[-1] in ("vr", "vc", "v") and sub[:-1] in flat:
            spec = flat[sub[:-1]]
            if names[-1] == "vr":      # reduced over last dim
                return spec[:-1]
            if names[-1] == "vc":      # reduced over second-to-last dim
                return spec[:-2] + spec[-1:]
            return spec
        return (None,) * leaf.ndim

    return unflatten(opt_state, [per_leaf(p, leaf)
                                 for p, leaf in items(opt_state)])


def opt_state_shardings(mesh, param_spec_tree, opt_state) -> dict:
    """``opt_state_specs`` as placements."""
    return tree_map(lambda s: placements(mesh, s),
                    opt_state_specs(mesh, param_spec_tree, opt_state))


def train_state_specs(cfg, mesh, opt):
    """(state as meta tensors, placements of the state): no
    allocation."""
    params = models.init_params(cfg, torch.Generator(), torch.device("meta"))
    p_shard = param_shardings(mesh, params)
    opt_state = opt.init(params)
    o_shard = opt_state_shardings(
        mesh, param_specs(mesh, stack_layers(params, cfg)), opt_state)
    step = torch.empty((), dtype=torch.int32, device="meta")
    state_shard = {"params": p_shard, "opt": o_shard,
                   "step": placements(mesh, ())}
    return {"params": params, "opt": opt_state, "step": step}, state_shard


def distribute_batch(batch, mesh):
    """A full batch (the same on every rank) onto ``mesh``, the batch dim
    over (``pod``, ``data``) where it divides."""
    return distribute(batch, mesh, batch_shardings(mesh, batch))
