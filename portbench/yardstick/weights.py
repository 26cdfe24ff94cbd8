"""Seeded random weights of a decoder-only LM, made on the device.

The benchmark makes the weights and hands the same to the program and to
the plain reference. They are drawn with a ``torch.Generator`` on the
device, in the dtype they are served in, one ``randn`` call per layer
(its seven projections are views of one buffer) plus one for the
embedding and one for an untied head. Every matrix is normal with the
published configuration's ``initializer_range`` as its standard
deviation (``dims["init_std"]``); the RMS norms' ``(1 + w)`` scales are
zeros, as the program initialises them. (At the program's own init, a
unit-normal embedding dominates the residual stream, and a tied head
then puts the input token first by tens of logits at every position:
greedy decoding repeats one token and no rounding could move it.)

The tree is the layout the program's models read:
``{"embed", "final_norm", ["lm_head"], "layers": [{"ln1", "mixer":
{"wq", "wk", "wv", "wo", ["q_norm", "k_norm"]}, "ln2", "ffn": {"w_gate",
"w_up", "w_down"}}]}``, a projection stored ``(d_in, d_out)``.
"""
from __future__ import annotations

import torch


def projection_shapes(dims: dict) -> dict:
    """(group, name) -> (d_in, d_out) of one layer's projections."""
    D, F = dims["d_model"], dims["d_ff"]
    q, kv = dims["n_heads"] * dims["head_dim"], \
        dims["n_kv_heads"] * dims["head_dim"]
    return {("mixer", "wq"): (D, q), ("mixer", "wk"): (D, kv),
            ("mixer", "wv"): (D, kv), ("mixer", "wo"): (q, D),
            ("ffn", "w_gate"): (D, F), ("ffn", "w_up"): (D, F),
            ("ffn", "w_down"): (F, D)}


def torch_seed(seed: int) -> int:
    """Any whole number as a seed ``torch.Generator`` takes."""
    return seed % (1 << 63)


def make_weights(dims: dict, seed: int, device, dtype) -> dict:
    """The tree of seeded weights for ``dims`` (see the module doc)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed))
    D, V, Dh = dims["d_model"], dims["vocab"], dims["head_dim"]
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=device)
    randn = lambda *s: torch.randn(s, generator=gen, dtype=dtype,
                                   device=device)
    std = dims["init_std"]
    params = {"embed": randn(V, D).mul_(std), "final_norm": zeros(D)}
    shapes = projection_shapes(dims)
    total = sum(a * b for a, b in shapes.values())
    layers = []
    for _ in range(dims["n_layers"]):
        flat = randn(total)
        layer = {"ln1": zeros(D), "mixer": {}, "ln2": zeros(D), "ffn": {}}
        off = 0
        flat.mul_(std)
        for (group, name), (d_in, d_out) in shapes.items():
            layer[group][name] = flat[off:off + d_in * d_out].view(d_in,
                                                                   d_out)
            off += d_in * d_out
        if dims["qk_norm"]:
            layer["mixer"]["q_norm"] = zeros(Dh)
            layer["mixer"]["k_norm"] = zeros(Dh)
        layers.append(layer)
    params["layers"] = layers
    if not dims["tie_embeddings"]:
        params["lm_head"] = randn(D, V).mul_(std)
    return params
