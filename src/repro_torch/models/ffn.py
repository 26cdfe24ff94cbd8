"""Dense gated MLP (port of ``repro/models/ffn.py``).

Projections go through ``quant.serve.qmatmul``: dense weights are a plain
matmul, PTQ'd QuantizedTensor weights the codebook-dequant kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.quant.serve import qmatmul
from repro_torch.runtime.hints import hint


def _dense(gen: torch.Generator, d_in: int, d_out: int, dtype,
           device) -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return w.div_(math.sqrt(d_in)).to(dtype)     # in place: one f32 copy


def init_ffn(cfg, gen: torch.Generator, dtype, device, *,
             d_ff: int | None = None) -> dict:
    """Gate, up and down projections of width ``d_ff`` (default
    ``cfg.d_ff``; MoE's shared experts pass theirs)."""
    F = d_ff or cfg.d_ff
    return {
        "w_gate": _dense(gen, cfg.d_model, F, dtype, device),
        "w_up": _dense(gen, cfg.d_model, F, dtype, device),
        "w_down": _dense(gen, F, cfg.d_model, dtype, device),
    }


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh") if kind == "gelu" else F.silu(x)


def ffn(params: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    h = _act(qmatmul(x, params["w_gate"]), cfg.act) * qmatmul(
        x, params["w_up"])
    h = hint(h, "ffn")
    return hint(qmatmul(h, params["w_down"]), "hidden")
