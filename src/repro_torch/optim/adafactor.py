"""Adafactor, factored second moments (port of
``repro/optim/adafactor.py``): O(n + m) second-moment storage for an
(n, m) matrix instead of O(nm), optional momentum, the state in bf16 for
the biggest archs.

A leaf of 2 or more dims keeps ``vr`` (its last dim averaged out) and
``vc`` (its second-to-last averaged out); a smaller one a full ``v``.
The update is clipped to RMS <= ``clip`` over the whole leaf. Math in f32,
storage in the state dtype, new params rounded to each param's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.runtime.hints import is_dtensor
from repro_torch.tree import leaves, tree_map


def _factored(p) -> bool:
    return p.dim() >= 2


def init(params, state_dtype=torch.float32, use_momentum=True) -> dict:
    def zeros(shape, p):
        return torch.zeros(shape, dtype=state_dtype, device=p.device)

    def v_init(p):
        if _factored(p):
            return {"vr": zeros(p.shape[:-1], p),
                    "vc": zeros(p.shape[:-2] + p.shape[-1:], p)}
        return {"v": zeros(p.shape, p)}

    state = {"v": tree_map(v_init, params),
             "count": torch.zeros((), dtype=torch.int32,
                                  device=leaves(params)[0].device)}
    if use_momentum:
        state["m"] = tree_map(lambda p: zeros(p.shape, p), params)
    return state


@torch.no_grad()
def update(grads, state, params, *, lr, b2=0.999, eps=1e-30, clip=1.0,
           weight_decay=0.0, b1=0.9):
    count = state["count"] + 1
    f32 = torch.float32

    def upd(g, vdict, p, m=None):
        # the reference's ops in its order; the in-place ops act on fresh
        # temporaries only, to hold ~3 leaf-sized f32 buffers at a time
        g32 = g.to(f32)
        g2 = (g32 * g32).add_(eps)
        if _factored(p):
            vr = b2 * vdict["vr"].to(f32) + (1 - b2) * g2.mean(-1)
            vc = b2 * vdict["vc"].to(f32) + (1 - b2) * g2.mean(-2)
            del g2
            denom = (vr[..., None] / torch.clamp(
                vr.mean(-1, keepdim=True)[..., None], min=eps)) \
                * vc[..., None, :]
            if is_dtensor(denom):   # DTensor refuses in-place on partials
                u = g32 / (denom + eps).sqrt()
            else:
                u = torch.div(g32, denom.add_(eps).sqrt_(), out=denom)
            new_v = {"vr": vr.to(vdict["vr"].dtype),
                     "vc": vc.to(vdict["vc"].dtype)}
        else:
            v = b2 * vdict["v"].to(f32) + (1 - b2) * g2
            del g2
            u = g32 / torch.sqrt(v + eps)
            new_v = {"v": v.to(vdict["v"].dtype)}
        # update clipping (RMS <= clip)
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)
        u.div_(torch.clamp(rms / clip, min=1.0))
        new_m = None
        if m is not None:
            u = m.to(f32, copy=True).mul_(b1).add_(u.mul_(1 - b1))
            new_m = u.to(m.dtype)
        step = p.to(f32, copy=True).mul_(weight_decay).add_(u)
        del u
        new_p = p.to(f32) - step.mul_(lr)
        return new_p.to(p.dtype), new_v, new_m

    has_m = "m" in state
    # grads drive the walk: each of its leaves meets its {"vr", "vc"} or
    # {"v"} dict (the reference's ``flatten_up_to``)
    out = tree_map(upd, grads, state["v"], params,
                   *([state["m"]] if has_m else []))
    new_state = {"v": tree_map(lambda t: t[1], out), "count": count}
    if has_m:
        new_state["m"] = tree_map(lambda t: t[2], out)
    return tree_map(lambda t: t[0], out), new_state
