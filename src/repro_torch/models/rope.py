"""Rotary position embeddings: standard RoPE and qwen2-vl's M-RoPE (port
of ``repro/models/rope.py``).

positions: (B, S) for RoPE; (3, B, S) for M-RoPE (temporal, h, w). The
vision frontend is a stub, so text positions replicate the temporal index
across the three streams, as qwen2-vl does for pure-text tokens."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) -> rotated x."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (D/2,)
    return _rotate(x, positions.float()[..., None] * freqs)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """M-RoPE: frequency band s of each half takes position stream s.
    x: (B, S, H, D); positions: (3, B, S); sections: per-stream half-dims
    summing to D/2."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"half the head dim {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (half,)
    parts, start = [], 0
    for s, sec in enumerate(sections):
        parts.append(positions[s].float()[..., None]
                     * freqs[start:start + sec])
        start += sec
    return _rotate(x, torch.cat(parts, dim=-1))             # (B, S, half)
