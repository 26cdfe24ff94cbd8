"""The plain reference of a training step: next-token cross-entropy plus
a 1e-4 z-loss over every token, its gradients by autograd, clipping by
the global norm (1.0) and AdamW (b1 0.9, b2 0.95, eps 1e-8, weight decay
0.1 on every leaf, f32 moments, the new params rounded to their dtype).

The model is ``model.py``'s layer (``_block``) without a cache or frozen
pages, one batch row at a time, each layer under activation
checkpointing and attention in query blocks, so that a row of 4,096
tokens fits at full width.
``lowp="fp8"`` is the control: projections and head on fp8 operands.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .model import _attend, _block, _mm, rms_norm

LOSS_CHUNK = 512


def _layer(x, layer, dims, lowp):
    return _block(x, layer, dims, 0, lowp,
                  lambda q, k, v: _attend(q, k, v, 0, 1024))[0]


def _row_sums(w, dims, tokens, labels, lowp):
    """(CE sum, z sum) of one row (T,) through the model."""
    x = w["embed"][tokens.long()]
    for layer in w["layers"]:
        x = checkpoint(_layer, x, layer, dims, lowp, use_reentrant=False)
    head = w["embed"].T if dims["tie_embeddings"] else w["lm_head"]
    ce = z = 0.0
    for lo in range(0, x.shape[0], LOSS_CHUNK):
        def chunk(xc, lc):
            h = rms_norm(xc, w["final_norm"], dims["rms_eps"])
            if lowp == "fp8":
                logits = _mm(h, head, lowp).float()
            else:
                logits = h.float() @ head.float()
            lse = torch.logsumexp(logits, dim=-1)
            picked = logits.gather(-1, lc[:, None].long())[:, 0]
            return torch.sum(lse - picked), torch.sum(lse ** 2)
        c, zz = checkpoint(chunk, x[lo:lo + LOSS_CHUNK],
                           labels[lo:lo + LOSS_CHUNK], use_reentrant=False)
        ce, z = ce + c, z + zz
    return ce, z


def loss_and_grads(w: dict, dims: dict, tokens, labels, lowp=None):
    """(loss, grads): ``w``'s leaves are tensors that require grad; the
    loss is mean CE + 1e-4 mean z over the batch's tokens."""
    B, S = tokens.shape
    n = B * S
    total = 0.0
    for b in range(B):
        ce, z = _row_sums(w, dims, tokens[b], labels[b], lowp)
        loss = (ce + 1e-4 * z) / n
        loss.backward()
        total += float(loss.detach())
    return total


def leaves(tree, path=()):
    """(path, tensor) of every tensor of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in leaves(v, path + (k,))]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree)
                for kv in leaves(v, path + (str(i),))]
    return [("/".join(path), tree)]


def leaf_key(path: str) -> str:
    """A leaf's name with its layer index (or its group's) left out, so
    that a stacked leaf and the layers it stacks share one key."""
    keep = [p for p in path.split("/")
            if not (p.isdigit() or p in ("layers", "groups")
                    or (p[:1] == "l" and p[1:].isdigit())
                    or p.startswith("head_"))]
    return "/".join(keep)


def norms(tree) -> dict:
    """key -> the f64 norm of every tensor under that key together."""
    sq: dict[str, float] = {}
    for path, t in leaves(tree):
        k = leaf_key(path)
        sq[k] = sq.get(k, 0.0) + float(torch.sum(t.double() ** 2))
    return {k: math.sqrt(v) for k, v in sq.items()}


@torch.no_grad()
def adamw_step(w: dict, m: dict, v: dict, count: int, *, lr: float,
               b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
               clip_norm=1.0) -> dict:
    """One clipped AdamW update of ``w`` (grads in ``.grad``) in place;
    returns the clipped f32 grads (the gradient as the optimizer got it)."""
    ps = [t for _, t in leaves(w)]
    gn = math.sqrt(sum(float(torch.sum(p.grad.float() ** 2)) for p in ps))
    scale = min(clip_norm / max(gn, 1e-9), 1.0)
    bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    got = {}
    for path, p in leaves(w):
        g = p.grad.float() * scale
        got[path] = g
        m[path] = b1 * m[path] + (1 - b1) * g
        v[path] = b2 * v[path] + (1 - b2) * g * g
        step = (m[path] / bc1) / (torch.sqrt(v[path] / bc2) + eps)
        step = step + weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))
        p.grad = None
    return got


def follow(weights: dict, dims: dict, batches: list, *, lr: float,
           lowp=None) -> dict:
    """Train ``weights`` (modified in place) for ``len(batches)`` steps of
    (tokens, labels). Returns the losses, the norms of the first clipped
    gradient by key, and the norms of the params' change by key."""
    start = {p: t.detach().clone() for p, t in leaves(weights)}
    for _, t in leaves(weights):
        t.requires_grad_(True)
    m = {p: torch.zeros_like(t, dtype=torch.float32)
         for p, t in leaves(weights)}
    v = {p: torch.zeros_like(t, dtype=torch.float32)
         for p, t in leaves(weights)}
    losses, first = [], None
    for i, (tok, lab) in enumerate(batches, start=1):
        losses.append(loss_and_grads(weights, dims, tok, lab, lowp))
        got = adamw_step(weights, m, v, i, lr=lr)
        if first is None:
            first = norms(as_tree(got))
        del got
    change = norms(as_tree({p: t.detach() - start[p]
                             for p, t in leaves(weights)}))
    return {"losses": losses, "grad": first, "change": change}


def as_tree(flat: dict) -> dict:
    """{path: tensor} -> nested dicts (keys are path parts)."""
    out: dict = {}
    for path, t in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return out


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared: ``loss_gap`` (the largest relative gap of a
    step's loss), ``grad_gap`` and ``change_gap`` (by the worst leaf: the
    gap between the two norms over the larger of the reference's norm of
    that leaf and of the median leaf). Leaves whose reference gradient is
    under a thousandth of the median leaf's are left out of both."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    med_g = sorted(ref["grad"].values())[len(ref["grad"]) // 2]
    keep = [k for k, g in ref["grad"].items() if g >= 1e-3 * med_g]

    def worst(kind):
        r = {k: ref[kind][k] for k in keep}
        med = sorted(r.values())[len(r) // 2]
        return max(abs(prog[kind].get(k, 0.0) - r[k]) / max(r[k], med)
                   for k in keep)

    return {"loss_gap": loss_gap, "grad_gap": worst("grad"),
            "change_gap": worst("change"),
            "left_out": sorted(set(ref["grad"]) - set(keep))}
