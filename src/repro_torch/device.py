"""Device resolution shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default ``"cuda"`` raises when no GPU is visible instead of quietly
falling back to the host.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None``/"cuda" -> the current CUDA device (raises without a GPU);
    "cpu" (or any explicit device) is taken as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' (or --device cpu) "
            "to run the port on the host")
    return dev
