"""The paper's experimental network, the 784-256-128-64-10 fully
connected MLP of §4.1 (port of ``repro/models/mlp.py``): a list of
{"w", "b"} layers, f32, ReLU between them.

Its §4.1 scenario lives here once, for
``examples/torch_train_quantized_mlp.py`` and ``chip_smoke.py``: ``synthetic_mnist`` (the data stand-in of the
reference's ``benchmarks/common.py``), ``train_paper_mlp`` (that module's
SGD loop) and ``qat_recover`` (the reference example's QAT of the last
layer), both through ``mlp_sgd``, as the reference's scans: 256-row
batches taken in order (mod n).
"""
from __future__ import annotations

import math

import numpy as np
import torch

PAPER_SIZES = (784, 256, 128, 64, 10)
MLP_STEPS, MLP_LR, MLP_BATCH = 400, 1e-3, 256
QAT_STEPS, QAT_LR = 100, 3e-3


def init_mlp(gen: torch.Generator, sizes=PAPER_SIZES, *, device) -> list:
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


def synthetic_mnist(n_train: int = 4096, n_test: int = 1024,
                    seed: int = 0) -> tuple:
    """The paper's §4.1 data stand-in: 10 class-conditioned 784-d blob
    patterns, noise 0.7; ((x_train, y_train), (x_test, y_test)) as
    numpy f32 and int32."""
    rng = np.random.default_rng(seed)
    protos = rng.uniform(0, 1, (10, 784)) * (
        rng.uniform(0, 1, (10, 784)) > 0.6)

    def make(n, s):
        r = np.random.default_rng(s)
        y = r.integers(0, 10, n)
        x = protos[y] + r.normal(0, 0.7, (n, 784))
        return np.clip(x, 0, 1).astype(np.float32), y.astype(np.int32)

    return make(n_train, seed + 1), make(n_test, seed + 2)


def mlp_sgd(params, x, y, loss_fn, steps: int, update) -> list:
    """``steps`` of SGD on MLP_BATCH-row batches taken in order (mod n):
    ``update(p, g)`` per leaf."""
    from repro_torch.tree import leaves, tree_map, unflatten

    ar = torch.arange(MLP_BATCH, device=x.device)
    for i in range(steps):
        idx = (ar + i * MLP_BATCH) % x.shape[0]
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        grads = torch.autograd.grad(loss_fn(p, x[idx], y[idx]), leaves(p))
        params = unflatten(params, [update(t.detach(), g) for t, g in
                                    zip(leaves(p), grads)])
    return params


def train_paper_mlp(params, x, y, steps: int = MLP_STEPS,
                    lr: float = MLP_LR) -> list:
    """The reference's ``benchmarks/common.py:train_paper_mlp`` loop (SGD
    at 3 x lr) from ``params``."""
    return mlp_sgd(params, x, y, mlp_loss, steps,
                   lambda p, g: p - lr * g * 3.0)


def qat_recover(params, cb, x, y, steps: int = QAT_STEPS,
                lr: float = QAT_LR) -> list:
    """The reference example's QAT: fine-tune through ``fake_quant`` of
    the last layer's weights on codebook ``cb``, then snap them to it."""
    from repro_torch.quant.qat import fake_quant

    def loss(p, xb, yb):
        return mlp_loss(p[:-1] + [dict(p[-1], w=fake_quant(p[-1]["w"], cb))],
                        xb, yb)

    p = mlp_sgd(params, x, y, loss, steps, lambda a, g: a - lr * g)
    return p[:-1] + [dict(p[-1], w=fake_quant(p[-1]["w"], cb))]
