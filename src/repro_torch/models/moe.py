"""Token-choice top-k Mixture of Experts with shared experts (port of
``repro/models/moe.py``).

Capacity-based dispatch: each batch row routes its S tokens to their top-k
experts, and an expert takes at most C = ceil(capacity_factor * S * K / E)
of a row's assignments, in token order; the rest are dropped (their
weight contributes 0). C is computed per call over the call's S, exactly
as in the reference: so which assignments drop depends on the length of
the call (a prefill chunk, a verify window), and a row's result never on
the rows beside it. Shared experts (deepseek) run densely on every token.

The router runs in f32 whatever the compute dtype. The expert products
are batched matmuls over the (E, C) slots, outside any hand-written
kernel, as the reference computes them outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.quant.serve import qmatmul
from repro_torch.runtime.hints import (gather_inner, gather_inner_grad, hint,
                                      is_dtensor, per_shard)

from .ffn import _act, _dense, init_ffn


def init_moe(cfg, gen: torch.Generator, dtype, device) -> dict:
    E, D, F = cfg.n_experts, cfg.d_model, cfg.expert_ff

    def stack(d_in, d_out):
        w = torch.randn((E, d_in, d_out), generator=gen, dtype=torch.float32,
                        device=device)
        # scaled in place: one f32 copy of the stack alive, not two (an
        # expert stack of jamba-1.5-large is 12 GiB in f32)
        return w.div_(math.sqrt(d_in)).to(dtype)

    p = {"router": _dense(gen, D, E, torch.float32, device),
         "w_gate": stack(D, F), "w_up": stack(D, F), "w_down": stack(F, D)}
    if cfg.n_shared_experts:
        p["shared"] = init_ffn(cfg, gen, dtype, device,
                               d_ff=cfg.expert_ff * cfg.n_shared_experts)
    return p


def _row_dispatch(flat_e: torch.Tensor, E: int, C: int):
    """Sort-based dispatch plan, batched over leading dims (each row on
    its own, as the reference's vmap of one row).

    flat_e: (..., SK) expert id per (token, k) assignment. Returns
      slot_tok: (..., E, C) assignment index filling each expert slot
      slot_ok:  (..., E, C) slot validity
      tok_pos:  (..., SK) rank of each assignment within its expert
    from a stable argsort, a left searchsorted and the inverse
    permutation (the reference's ``.at[order].set``)."""
    SK = flat_e.shape[-1]
    lead = flat_e.shape[:-1]
    dev = flat_e.device
    order = torch.argsort(flat_e, dim=-1, stable=True)          # (..., SK)
    sorted_e = torch.gather(flat_e, -1, order).contiguous()
    experts = torch.arange(E, dtype=flat_e.dtype, device=dev)
    first_of = torch.searchsorted(
        sorted_e, experts.expand(*lead, E).contiguous(), right=False)
    idx = first_of[..., None] + torch.arange(C, device=dev)      # (..., E, C)
    safe = idx.clamp(0, SK - 1).reshape(*lead, E * C)
    hit = torch.gather(sorted_e, -1, safe).reshape(*lead, E, C)
    slot_ok = (idx < SK) & (hit == experts[:, None])
    slot_tok = torch.gather(order, -1, safe).reshape(*lead, E, C)
    first_all = torch.searchsorted(sorted_e, sorted_e, right=False)
    pos_sorted = torch.arange(SK, device=dev) - first_all
    tok_pos = torch.zeros_like(order).scatter_(-1, order, pos_sorted)
    return slot_tok, slot_ok, tok_pos


def capacity(cfg, S: int) -> int:
    """Slots an expert takes of one row of a call of S tokens."""
    return int(math.ceil(cfg.capacity_factor * S * cfg.top_k
                         / cfg.n_experts))


def route(params, cfg, x: torch.Tensor):
    """The router in f32: (top-k weights renormalized (B, S, K) f32,
    expert ids (B, S, K))."""
    logits = gather_inner_grad(torch.einsum(
        "bsd,de->bse", gather_inner(x).float(), params["router"].float()))
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    return top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9), top_i


def _experts(x, w):
    """(B, E, C, d_in) x (E, d_in, d_out) -> (B, E, C, d_out): each
    expert's slots through its weight. The experts are laid out leading
    and contiguous first, the order the einsum's batched matmul takes
    them in (the same product, bit for bit). On a mesh the copy is
    forced: after a redistribute a DTensor's local block may be laid out
    otherwise than its global strides say, ``contiguous()`` then skips
    the copy, and the einsum's reshape cannot view the block (granite's
    40 experts on a 16-wide model axis)."""
    xt = x.transpose(0, 1)
    xt = (xt.clone(memory_format=torch.contiguous_format) if is_dtensor(xt)
          else xt.contiguous())
    return torch.einsum("ebcd,edf->ebcf", xt, w).transpose(0, 1)


def moe_ffn(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    top_w, top_i = route(params, cfg, x)
    C = capacity(cfg, S)
    flat_e = top_i.reshape(B, S * K)
    slot_tok, slot_ok, tok_pos = per_shard(
        lambda fe: _row_dispatch(fe, E, C), flat_e)

    # dispatch: gather tokens into (B, E, C, D); slot -> source token a // K
    src_tok = (slot_tok // K).reshape(B, E * C)
    buf = torch.gather(x, 1, src_tok[..., None].expand(B, E * C, D))
    buf = buf.reshape(B, E, C, D) * slot_ok[..., None].to(x.dtype)
    buf = hint(buf, "moe_buf")

    h = _experts(buf, params["w_gate"])
    h = _act(h, cfg.act) * _experts(buf, params["w_up"])
    h = hint(h, "moe_h")
    out = _experts(h, params["w_down"])
    out = hint(out, "moe_buf")

    # combine: gather each assignment's slot back; dropped ones give 0
    keep = tok_pos < C
    gather_idx = flat_e * C + torch.where(keep, tok_pos,
                                          torch.zeros_like(tok_pos))
    y_tok = torch.gather(out.reshape(B, E * C, D), 1,
                         gather_idx[..., None].expand(B, S * K, D))
    y_tok = hint(y_tok, "moe_tok")
    y_tok = y_tok * keep[..., None].to(out.dtype)
    y = (y_tok.reshape(B, S, K, D)
         * top_w[..., None].to(out.dtype)).sum(dim=2)
    if "shared" in params:
        sh = params["shared"]
        y = y + qmatmul(_act(qmatmul(x, sh["w_gate"]), cfg.act)
                        * qmatmul(x, sh["w_up"]), sh["w_down"])
    return hint(y, "hidden")


def router_aux_loss(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Load-balance auxiliary loss (Switch-style): E * sum_e f_e * p_e."""
    xt = x.reshape(-1, x.shape[-1]).float()
    probs = torch.softmax(xt @ params["router"].float(), dim=-1)
    top_i = probs.argmax(dim=-1)
    f = torch.nn.functional.one_hot(top_i, cfg.n_experts).float().mean(0)
    return cfg.n_experts * (f * probs.mean(0)).sum()
