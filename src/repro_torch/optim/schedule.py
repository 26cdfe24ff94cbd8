"""LR schedules, pure functions of the step (port of
``repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(step, *, peak_lr, warmup_steps, total_steps,
                       final_frac=0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to
    ``final_frac * peak_lr`` at ``total_steps``; f32 like the reference."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)
