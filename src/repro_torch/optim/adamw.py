"""AdamW with a configurable state dtype (port of ``repro/optim/adamw.py``).

Functional, on dicts of tensors: ``update`` returns new params and a new
state and writes nothing in place. The math runs in f32 whatever the
storage dtype; the moments are stored in the state dtype and the new
params rounded to each param's dtype, in the reference's order (decay
added to the Adam step, then one ``lr`` step). ``torch.optim.AdamW``
applies the decay before the step and keeps f32 state, so it is not used.
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map


def init(params, state_dtype=torch.float32) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=state_dtype, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=leaves(params)[0].device)}


@torch.no_grad()
def update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
           weight_decay=0.1):
    count = state["count"] + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c

    def upd(g, m, v, p):
        g32 = g.to(torch.float32)
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g32
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g32 * g32
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
        step = step + weight_decay * p.to(torch.float32)
        new_p = p.to(torch.float32) - lr * step
        return new_p.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    out = tree_map(upd, grads, state["m"], state["v"], params)
    new_params, new_m, new_v = (tree_map(lambda t, i=i: t[i], out)
                                for i in range(3))
    return new_params, {"m": new_m, "v": new_v, "count": count}
