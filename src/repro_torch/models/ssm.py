"""Attention-free sequence mixers (port of ``repro/models/ssm.py``): Mamba
(a selective diagonal SSM) and RWKV-6 (Finch, data-dependent decay).

A prompt runs as chunks of ``cfg.scan_chunk`` positions, the recurrent
state carried from chunk to chunk: within a chunk Mamba's recurrence is a
log-depth doubling scan (the reference's ``lax.associative_scan``, in
another combine order, so parity is by tolerance) and RWKV-6's the
chunked matmul form of the WKV recurrence. A decode step (S == 1) is one
O(1) state update. A prompt that is not a multiple of the chunk is padded
with positions that leave the state unchanged: Mamba pads dt after its
softplus with zeros (a = 1, b = 0), RWKV pads w = 1, k = 0.

Dtypes follow the reference leaf for leaf: in a bf16 model ``A_log``,
``D_skip``, ``w0``, ``u`` and the states ``h`` and ``s`` stay f32, the
discretization and the WKV run in f32, and the mixer output is cast back
to the compute dtype before its gate. Projections go through
``quant.serve.qmatmul``, as the attention mixers' do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.quant.serve import qmatmul
from repro_torch.runtime.hints import (hint, merge_heads, per_shard,
                                      split_heads)

from .ffn import _dense
from .norms import init_rms, rms_norm


def _randn(gen, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


def _pad_seq(t: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    """``t`` (B, S, ...) with ``pad`` positions of ``value`` appended."""
    if not pad:
        return t
    fill = t.new_full((t.shape[0], pad, *t.shape[2:]), value)
    return torch.cat([t, fill], dim=1)


# =================================================================== Mamba

def init_mamba(cfg, gen: torch.Generator, dtype, device) -> dict:
    D, E, N, R, dc = (cfg.d_model, cfg.d_inner, cfg.ssm_d_state,
                      cfg.dt_rank, cfg.ssm_d_conv)
    A = torch.arange(1, N + 1, dtype=torch.float32, device=device)
    return {
        "w_in": _dense(gen, D, 2 * E, dtype, device),
        "conv_w": (_randn(gen, (dc, E), device) / dc).to(dtype),
        "w_bcdt": _dense(gen, E, 2 * N + R, dtype, device),
        "w_dt": _dense(gen, R, E, dtype, device),
        "dt_bias": torch.full((E,), -2.0, dtype=dtype, device=device),
        "A_log": torch.log(A).expand(E, N).clone(),
        "D_skip": torch.ones((E,), dtype=torch.float32, device=device),
        "w_out": _dense(gen, E, D, dtype, device),
    }


def _mamba_scan_chunk(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """The diagonal SSM h_t = a_t * h_{t-1} + b_t over one chunk, as a
    Hillis-Steele doubling scan of the combine (a1, b1), (a2, b2) ->
    (a1 * a2, a2 * b1 + b2). a, b: (B, c, E, N) f32; h0: (B, E, N).
    Returns (every state (B, c, E, N), the last (B, E, N))."""
    c, d = a.shape[1], 1
    while d < c:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    h = b + a * h0[:, None]
    return h, h[:, -1]


def _discretize(xc, dt, B_t, A):
    """(B, c, E), (B, c, E), (B, c, N) -> a, b (B, c, E, N) f32, one chunk
    at a time (the whole sequence's would not fit at jamba's width)."""
    dtf = dt.float()
    a = torch.exp(dtf[..., None] * A)
    b = (dtf * xc.float())[..., None] * B_t.float()[:, :, None, :]
    return a, b


def mamba(params, cfg, x: torch.Tensor, *, cache=None):
    """x: (B, S, D). cache: {"h": (B, E, N) f32, "conv": (B, dc - 1, E)},
    the state and the last dc - 1 conv inputs. Returns (y, new cache or
    None)."""
    B, S, _ = x.shape
    E, N, R, dc = cfg.d_inner, cfg.ssm_d_state, cfg.dt_rank, cfg.ssm_d_conv
    xs, z = qmatmul(x, params["w_in"]).chunk(2, dim=-1)     # (B, S, E) each
    xs = hint(xs, "ssm_inner")
    # causal depthwise conv over the cached inputs (zeros without a cache)
    if cache is not None:
        ctx = torch.cat([cache["conv"].to(xs.dtype), xs], dim=1)
    else:
        ctx = F.pad(xs, (0, 0, dc - 1, 0))
    new_conv = ctx[:, -(dc - 1):]
    conv_w = params["conv_w"]
    xc = F.silu(sum(ctx[:, i:i + S] * conv_w[i] for i in range(dc)))

    B_t, C_t, dt_low = qmatmul(xc, params["w_bcdt"]).split([N, N, R], -1)
    dt = F.softplus(qmatmul(dt_low, params["w_dt"])
                    + params["dt_bias"].to(xc.dtype))          # (B, S, E)
    A = -torch.exp(params["A_log"])                            # (E, N) f32
    h0 = (cache["h"] if cache is not None else
          torch.zeros((B, E, N), dtype=torch.float32, device=x.device))
    if S == 1:                                   # decode: one O(1) update
        a, b = _discretize(xc, dt, B_t, A)
        h_last = a[:, 0] * h0 + b[:, 0]
        y = torch.einsum("ben,bn->be", h_last, C_t[:, 0].float())[:, None]
    else:
        c = min(cfg.scan_chunk, S)
        pad = (-S) % c
        dt_p = _pad_seq(dt, pad)      # after the softplus: a = 1, b = 0
        h_last, ys = h0, []
        for xc_c, dt_c, B_c, C_c in zip(
                *(t.split(c, dim=1) for t in (_pad_seq(xc, pad), dt_p,
                                              _pad_seq(B_t, pad),
                                              _pad_seq(C_t, pad)))):
            a, b = _discretize(xc_c, dt_c, B_c, A)
            states, h_last = _mamba_scan_chunk(a, b, h_last)
            ys.append(torch.einsum("bsen,bsn->bse", states, C_c.float()))
        y = torch.cat(ys, dim=1)[:, :S]
    y = y + params["D_skip"] * xc.float()
    y = qmatmul(y.to(x.dtype) * F.silu(z), params["w_out"])
    new_cache = {"h": h_last, "conv": new_conv} if cache is not None else None
    return hint(y, "hidden"), new_cache


def init_mamba_cache(cfg, batch: int, dtype, device) -> dict:
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_d_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
    }


# =================================================================== RWKV-6

def init_rwkv6(cfg, gen: torch.Generator, dtype, device) -> dict:
    """Time-mix and channel-mix parameters (the channel mix's ``cmix`` and
    ``c_*`` live in the mixer dict, as in the reference)."""
    D, lora = cfg.d_model, 64

    def uniform(rows):
        return torch.rand((rows, D), generator=gen, dtype=torch.float32,
                          device=device).to(dtype)

    return {
        "mix": uniform(5),
        "w_r": _dense(gen, D, D, dtype, device),
        "w_k": _dense(gen, D, D, dtype, device),
        "w_v": _dense(gen, D, D, dtype, device),
        "w_g": _dense(gen, D, D, dtype, device),
        "w0": torch.full((D,), -6.0, dtype=torch.float32, device=device),
        "w_lora_a": _dense(gen, D, lora, dtype, device),
        "w_lora_b": (_randn(gen, (lora, D), device) * 0.01).to(dtype),
        "u": _randn(gen, (D,), device) * 0.1,
        "ln_out": init_rms(D, dtype, device),
        "w_o": _dense(gen, D, D, dtype, device),
        "cmix": uniform(2),
        "c_k": _dense(gen, D, cfg.d_ff, dtype, device),
        "c_v": _dense(gen, cfg.d_ff, D, dtype, device),
        "c_r": _dense(gen, D, D, dtype, device),
    }


def _token_shift(x: torch.Tensor, shift_state: torch.Tensor):
    """Previous-token features (B, S, D) and the carry (B, D)."""
    prev = torch.cat([shift_state[:, None], x[:, :-1]], dim=1)
    return prev, x[:, -1]


def _wkv6_chunk_matmul(r, k, v, w, u, s0, *, clamp: float = 15.0):
    """One chunk of the WKV recurrence as matmuls (GLA-style). With the
    cumulative decay W_t = prod_{tau<=t} w_tau:

      y_t = (r_t W_{t-1}) . S_0 + sum_{tau<t} [(r_t W_{t-1} / W_tau) . k_tau]
            v_tau + (r_t . (u k_t)) v_t
      S_c = W_c S_0 + sum_tau (W_c / W_tau) k_tau v_tau^T

    The pairwise decays are exact on the causal region (their exponent is
    <= 0) and clipped then masked elsewhere; the chunk's total decay W_c
    is floored at e^-clamp and W_c / W_tau capped at e^clamp, as in the
    reference. r, k, v, w: (B, c, H, hd) f32; u: (1, H, hd, 1); s0: (B, H,
    hd, hd). Returns (y (B, c, H, hd), S_c)."""
    c = r.shape[1]
    logw_t = torch.log(torch.clamp(w, min=1e-12))
    logw = torch.cumsum(logw_t, dim=1)                         # <= 0
    logw_prev = logw - logw_t                                  # W_{t-1}
    r_dec = r * torch.exp(logw_prev)
    Fd = torch.exp(torch.clamp(logw_prev[:, :, None] - logw[:, None, :],
                               max=0.0))                       # (B,c,c,H,hd)
    A = torch.einsum("btshd,bshd->bhts", r[:, :, None] * Fd, k)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    A = torch.where(tri, A, 0.0)
    diag = (r * u[0, :, :, 0] * k).sum(-1)                     # (B, c, H)
    y = (torch.einsum("bhts,bshd->bthd", A, v) + diag[..., None] * v
         + torch.einsum("bthd,bhdv->bthv", r_dec, s0))
    k_tail = k * torch.exp(torch.clamp(logw[:, -1:] - logw, max=clamp))
    w_c = torch.exp(torch.clamp(logw[:, -1], min=-clamp))      # (B, H, hd)
    s_new = w_c[..., None] * s0 + torch.einsum("bshd,bshv->bhdv", k_tail, v)
    return y, s_new


def _wkv6_chunk(r, k, v, w, u, s0):
    """The WKV recurrence step by step (the decode path, and the oracle of
    the matmul form): y_t = r_t . (S_{t-1} + u k_t v_t^T),
    S_t = diag(w_t) S_{t-1} + k_t v_t^T."""
    s, ys = s0, []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]         # (B,H,hd,hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + u * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def rwkv6_time_mix(params, cfg, x: torch.Tensor, *, shift_state,
                   wkv_state):
    """x: (B, S, D); shift_state (B, D); wkv_state (B, H, hd, hd) f32.
    Returns (y, the new shift state, the new wkv state)."""
    _, S, D = x.shape
    hd = cfg.rwkv_head_dim
    H = D // hd
    prev, new_shift = _token_shift(x, shift_state)
    mix = params["mix"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + (prev - x) * mix[i] for i in range(5))
    r = split_heads(qmatmul(xr, params["w_r"]), H, hd)
    k = split_heads(qmatmul(xk, params["w_k"]), H, hd)
    v = split_heads(qmatmul(xv, params["w_v"]), H, hd)
    g = F.silu(qmatmul(xg, params["w_g"]))
    # the data-dependent decay (Finch), in f32
    dec = params["w0"] + qmatmul(torch.tanh(qmatmul(xw, params["w_lora_a"])),
                                 params["w_lora_b"]).float()
    w = split_heads(torch.exp(-torch.exp(dec)), H, hd)       # in (0, 1)
    u = params["u"].float().reshape(H, hd)[None, :, :, None]
    rf, kf, vf, w = (hint(t.float(), "wkv") for t in (r, k, v, w))

    def wkv(rf, kf, vf, w, s0, u):
        if S == 1:
            return _wkv6_chunk(rf, kf, vf, w, u, s0)
        c = min(cfg.scan_chunk, S)
        pad = (-S) % c             # w = 1, k = 0: the state passes through
        rf, kf, vf = (_pad_seq(t, pad) for t in (rf, kf, vf))
        wf = _pad_seq(w, pad, 1.0)
        s_last, ys = s0, []
        for chunk in zip(*(t.split(c, dim=1) for t in (rf, kf, vf, wf))):
            y_c, s_last = _wkv6_chunk_matmul(*chunk, u, s_last)
            ys.append(y_c)
        return torch.cat(ys, dim=1)[:, :S], s_last

    # on a mesh, each rank's batch rows on their own (the recurrence is
    # per row): DTensor's einsums fail on its sharded blocks
    ys, s_last = per_shard(wkv, rf, kf, vf, w, wkv_state, shared=(u,))
    y = merge_heads(ys).to(x.dtype)
    y = rms_norm(y, params["ln_out"]) * g
    return hint(qmatmul(y, params["w_o"]), "hidden"), new_shift, s_last


def rwkv6_channel_mix(params, cfg, x: torch.Tensor, *, shift_state):
    """The channel mix (RWKV's FFN); returns (y, the new shift state)."""
    prev, new_shift = _token_shift(x, shift_state)
    cmix = params["cmix"].to(x.dtype)
    xk = x + (prev - x) * cmix[0]
    xr = x + (prev - x) * cmix[1]
    kk = torch.square(torch.relu(qmatmul(xk, params["c_k"])))
    return (torch.sigmoid(qmatmul(xr, params["c_r"]))
            * qmatmul(kk, params["c_v"])), new_shift


def wkv_state(cfg, batch: int, device) -> torch.Tensor:
    """A zero WKV state (B, H, hd, hd) f32."""
    hd = cfg.rwkv_head_dim
    return torch.zeros((batch, cfg.d_model // hd, hd, hd),
                       dtype=torch.float32, device=device)


def init_rwkv_cache(cfg, batch: int, dtype, device) -> dict:
    D = cfg.d_model
    return {
        "shift_t": torch.zeros((batch, D), dtype=dtype, device=device),
        "shift_c": torch.zeros((batch, D), dtype=dtype, device=device),
        "s": wkv_state(cfg, batch, device),
    }
