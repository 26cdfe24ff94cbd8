"""The plain reference of the served models: a decoder-only LM with GQA,
optional qk-norm, rotary positions (rotate-half), RMS norms with the
``(1 + w)`` scale, a SwiGLU FFN and a tied or untied head, as the
configuration file's dims state it. Plain torch, one request at a time,
over the whole sequence, in query blocks so that it fits at full width.

Precision: the weights and activations are bf16 (the configuration's
dtype); norm statistics, rotary angles, attention scores, the softmax and
the value products are f32; logits are f32 products of the bf16 operands.

The KV cache's frozen pages (``kv_quant``): full pages of ``block``
positions freeze to ``num_values``-value codebooks per (page, layer, k/v)
row (``pages.freeze_rows``). A prompt is prefilled over exact K/V; then
its pages and, as they fill, the served tokens' pages freeze, each some
steps after it became readable frozen. ``served_logits`` scores the
served positions under each ``lag``: a served token at position ``t``
reads page ``p`` frozen iff ``t >= max(block * (p + 1), prompt_len) +
lag``, every other key exact. Lag 0 is a freeze that lands before the
next step reads (the synchronous freeze); the program's asynchronous
freeze is dispatched at the start of a step and installed at a later
step's poll, so its pages read exact for one step or more after they
fill.

``lowp="fp8"`` is the control: every projection and the head take
float8_e4m3 operands (activations scaled per row, weights per output
column, to e4m3's largest value), the nearest precision below bf16.
"""
from __future__ import annotations

import math

import torch

from .pages import freeze_rows
from .ptq import quantize_weight

E4M3_MAX = 448.0


def quantized_weights(weights: dict, dims: dict, num_values: int) -> dict:
    """``weights`` with every projection replaced by its dense
    reconstruction from the reference's own kmeans_ls codes (bf16),
    one projection at a time; the other leaves as they are."""
    out = {k: v for k, v in weights.items() if k != "layers"}
    out["layers"] = []
    for layer in weights["layers"]:
        new = {}
        for group, leaf in layer.items():
            if not isinstance(leaf, dict):
                new[group] = leaf
                continue
            new[group] = {}
            for name, w in leaf.items():
                if w.dim() < 2:
                    new[group][name] = w
                    continue
                cb, codes = quantize_weight(w, num_values)
                new[group][name] = cb[codes].to(w.dtype)
                del codes
        out["layers"].append(new)
    return out


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8_e4m3, scaled along ``dim`` to its range."""
    amax = x.float().abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / E4M3_MAX
    q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return q.to(x.dtype)


def _mm(x: torch.Tensor, w: torch.Tensor, lowp: str | None):
    if lowp == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    xf = x.float()
    inv = ((xf * xf).mean(-1, keepdim=True) + eps) ** -0.5
    return x * inv.to(x.dtype) * (1.0 + scale.float()).to(x.dtype)


def rope(x: torch.Tensor, theta: float, start: int = 0) -> torch.Tensor:
    """x (T, heads, Dh), row i at position ``start + i``."""
    T, _, Dh = x.shape
    half = Dh // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = torch.arange(start, start + T, dtype=torch.float32,
                       device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _frozen(kv: torch.Tensor, block: int, num_values: int) -> torch.Tensor:
    """Every full page of ``kv`` (T, Hkv, Dh) replaced by its frozen
    values (f32); the rows past the last full page as they are."""
    T = kv.shape[0]
    full = T // block
    out = kv.float().clone()
    if full:
        rows = kv[:full * block].reshape(full, -1)
        out[:full * block] = freeze_rows(rows, num_values).reshape(
            full * block, *kv.shape[1:])
    return out


def _attend(q, k, v, start: int, q_block: int, frozen=None):
    """GQA attention of the queries q (n, H, Dh) at positions ``start`` ..
    ``start + n - 1`` over the keys k, v (T, Hkv, Dh) at positions 0 ..
    T - 1, causal. ``frozen = (kf, vf, use)``: the frozen keys and values
    (T, Hkv, Dh) f32 and ``use(pos, key)``, where a query reads them."""
    n, H, Dh = q.shape
    T, Hkv = k.shape[:2]
    G = H // Hkv
    kT = k.float().permute(1, 2, 0)                     # (Hkv, Dh, T)
    vv = v.float().permute(1, 0, 2)                     # (Hkv, T, Dh)
    if frozen is not None:
        kfT, vfv = frozen[0].permute(1, 2, 0), frozen[1].permute(1, 0, 2)
    key = torch.arange(T, device=q.device)
    out = torch.empty((n, H, Dh), dtype=q.dtype, device=q.device)
    scale = 1.0 / math.sqrt(Dh)
    for lo in range(0, n, q_block):
        hi = min(lo + q_block, n)
        pos = torch.arange(start + lo, start + hi, device=q.device)
        qb = q[lo:hi].float().reshape(hi - lo, Hkv, G, Dh).permute(1, 2, 0, 3)
        s = torch.matmul(qb, kT[:, None]) * scale       # (Hkv, G, b, T)
        causal = key[None, :] <= pos[:, None]
        if frozen is not None:
            use_f = frozen[2](pos[:, None], key[None, :])
            s = torch.where(use_f, torch.matmul(qb, kfT[:, None]) * scale,
                            s)
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        if frozen is not None:
            o = (torch.matmul(p * ~use_f, vv[:, None])
                 + torch.matmul(p * use_f, vfv[:, None]))
        else:
            o = torch.matmul(p, vv[:, None])
        out[lo:hi] = o.permute(2, 0, 1, 3).reshape(hi - lo, H, Dh).to(
            q.dtype)
    return out


def _block(x, layer, dims, start, lowp, attend):
    """One layer over rows at positions ``start`` ..: returns the new x
    and this layer's (k, v) of those rows; ``attend(q, k, v)`` does the
    attention."""
    T = x.shape[0]
    H, Hkv, Dh = dims["n_heads"], dims["n_kv_heads"], dims["head_dim"]
    eps = dims["rms_eps"]
    a, f = layer["mixer"], layer["ffn"]
    h = rms_norm(x, layer["ln1"], eps)
    q = _mm(h, a["wq"], lowp).reshape(T, H, Dh)
    k = _mm(h, a["wk"], lowp).reshape(T, Hkv, Dh)
    v = _mm(h, a["wv"], lowp).reshape(T, Hkv, Dh)
    if dims["qk_norm"]:
        q = rms_norm(q, a["q_norm"], eps)
        k = rms_norm(k, a["k_norm"], eps)
    q = rope(q, dims["rope_theta"], start)
    k = rope(k, dims["rope_theta"], start)
    o = attend(q, k, v)
    x = x + _mm(o.reshape(T, H * Dh), a["wo"], lowp)
    h = rms_norm(x, layer["ln2"], eps)
    g = torch.nn.functional.silu(_mm(h, f["w_gate"], lowp)) \
        * _mm(h, f["w_up"], lowp)
    return x + _mm(g, f["w_down"], lowp), (k, v)


def _head(weights, dims, x, lowp):
    h = rms_norm(x, weights["final_norm"], dims["rms_eps"])
    head = (weights["embed"].T if dims["tie_embeddings"]
            else weights["lm_head"])
    if lowp == "fp8":
        return _fp8(h, -1).float() @ _fp8(head, 0).float()
    return h.float() @ head.float()


@torch.no_grad()
def served_logits(weights: dict, dims: dict, tokens: torch.Tensor,
                  prompt_len: int, *, block: int, num_values: int,
                  lags=(0,), lowp: str | None = None,
                  q_block: int = 1024) -> dict:
    """{lag: logits (n, V) f32}: row k scores served token k, at position
    ``prompt_len - 1 + k`` of ``tokens`` (T,), the prompt followed by the
    served tokens but the last. The prompt's pass is shared by every lag;
    each lag then runs the served positions over the prompt's K/V."""
    P, T = prompt_len, tokens.shape[0]
    x = weights["embed"][tokens[:P].long()]
    cache = []
    for layer in weights["layers"]:
        x, kv = _block(x, layer, dims, 0, lowp,
                       lambda q, k, v: _attend(q, k, v, 0, q_block))
        cache.append(kv)
    first = _head(weights, dims, x[P - 1:], lowp)
    out = {}
    for lag in lags:
        if T == P:
            out[lag] = first
            continue
        x = weights["embed"][tokens[P:].long()]

        def use(pos, key, lag=lag):
            return pos >= torch.clamp((key // block + 1) * block, min=P) + lag

        for layer, (kp, vp) in zip(weights["layers"], cache):
            def attend(q, k, v, kp=kp, vp=vp):
                ka, va = torch.cat([kp, k]), torch.cat([vp, v])
                fz = (_frozen(ka, block, num_values),
                      _frozen(va, block, num_values), use)
                return _attend(q, ka, va, P, q_block, fz)

            x, _ = _block(x, layer, dims, P, lowp, attend)
        out[lag] = torch.cat([first, _head(weights, dims, x, lowp)])
    return out
