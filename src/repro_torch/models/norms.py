"""RMSNorm (port of ``repro/models/norms.py``).

(1 + w) parameterization with w initialized to zero, as in the reference.
"""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    """Mean-square in f32; the full-size products stay in x.dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    inv = ((var + eps) ** -0.5).to(x.dtype)
    w = (1.0 + scale.float()).to(x.dtype)
    return x * inv * w


def init_rms(d: int, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=dtype, device=device)
