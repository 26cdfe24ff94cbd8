"""Device resolution shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default ``"cuda"`` raises when no GPU is visible instead of quietly
falling back to the host.
"""
from __future__ import annotations

import subprocess

import torch

# The H100 SXM's peaks (NVIDIA data sheet, dense, at the 700 W limit),
# defined here once: ``analysis.roofline``, ``obs.export``'s gauges and
# ``chip_smoke.py``'s kernel bounds read these objects.

#: HBM3 bandwidth, the memory rate of every roofline of the port
HBM_BYTES_PER_S = 3.35e12
#: bf16 on the tensor cores, f32 accumulation
BF16_FLOPS = 989e12
#: f32 outside the tensor cores: the port runs with TF32 off
F32_FLOPS = 67e12
#: NVLink 4, one way: 900 GB/s both ways, and a device's collective bytes
#: are the bytes it sends
LINK_BYTES_PER_S = 450e9


def resolve_device(device=None) -> torch.device:
    """``None``/"cuda" -> the current CUDA device (raises without a GPU);
    "cpu" (or any explicit device) is taken as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' (or --device cpu) "
            "to run the port on the host")
    return dev


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them: what every time
    measured on the card is printed beside (a card may be capped below
    its 700 W maximum)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def where(dev: torch.device) -> str:
    """What a reading was taken on: the card's ``card_line`` on CUDA,
    else "the CPU"."""
    return card_line() if dev.type == "cuda" else "the CPU"
