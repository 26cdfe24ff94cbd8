"""The paper's experimental network, the 784-256-128-64-10 fully
connected MLP of §4.1 (port of ``repro/models/mlp.py``): a list of
{"w", "b"} layers, f32, ReLU between them."""
from __future__ import annotations

import math

import torch

PAPER_SIZES = (784, 256, 128, 64, 10)


def init_mlp(gen: torch.Generator, sizes=PAPER_SIZES, device="cpu") -> list:
    """He-normal weights from ``gen`` (on ``device``), zero biases. torch
    and jax draw different numbers from one seed: parity tests convert the
    reference's (``convert.mlp_params_from_reference``)."""
    return [{"w": torch.randn((a, b), generator=gen, dtype=torch.float32,
                              device=device) * math.sqrt(2.0 / a),
             "b": torch.zeros((b,), dtype=torch.float32, device=device)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def mlp_loss(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(mlp_apply(params, x), dim=-1)
    return -torch.mean(torch.gather(logp, 1, y.long()[:, None]))


def mlp_accuracy(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(mlp_apply(params, x), -1)
                       == y.long()).to(torch.float32))
