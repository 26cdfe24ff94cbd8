"""Optimizers (port of ``repro/optim``): AdamW and Adafactor.

``Optimizer`` dispatches ``cfg.optimizer`` to a module with
``init(params, state_dtype)`` and ``update(grads, state, params, *, lr)``.
Built with a model config (``for_config``), it keeps the optimizer state
in the reference's stacked layout: the reference scans identical layer
groups, so each of its group leaves is one array with a leading group
axis, and Adafactor factors and clips that whole array. The port's
params hold a list of layers, so ``update`` stacks them into the
reference's tree (``head_<i>``, ``groups/l<j>``, ``enc_groups/l0``), runs
the reference's math on it one leaf at a time, and hands back the new
params as the port's list of layers (views of the stacked results). The
state has the reference's tree and shapes leaf for leaf.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import _DTYPES
from repro_torch.tree import tree_map

from . import adafactor, adamw
from .schedule import cosine_with_warmup


def _ref_layout(params, cfg, join) -> dict:
    """The port's params (a list of layers) -> the reference's tree, each
    group leaf the ``join`` of its layers' tensors (group order)."""
    if "layers" not in params:
        return params

    def stacked(trees):
        return tree_map(lambda *ts: join(ts), trees[0], *trees[1:])

    out = {k: v for k, v in params.items()
           if k not in ("layers", "enc_layers")}
    n_head, glen = len(cfg.head_layers), len(cfg.group)
    layers = params["layers"]
    for i in range(n_head):
        out[f"head_{i}"] = layers[i]
    if cfg.n_groups:
        out["groups"] = {f"l{j}": stacked(layers[n_head + j::glen])
                         for j in range(glen)}
    if "enc_layers" in params:
        out["enc_groups"] = {"l0": stacked(params["enc_layers"])}
    return out


def stack_layers(params, cfg) -> dict:
    """The port's params (a list of layers) -> the reference's tree, each
    group leaf stacked on a new leading group axis."""
    return _ref_layout(params, cfg, torch.stack)


def unstack_layers(tree, cfg) -> dict:
    """The inverse of ``stack_layers``: group g's layers are views of
    index g of each stacked leaf."""
    if "groups" not in tree and "head_0" not in tree:
        return tree
    n_head, glen = len(cfg.head_layers), len(cfg.group)
    out = {k: v for k, v in tree.items() if k not in ("groups", "enc_groups")
           and not k.startswith("head_")}
    out["layers"] = [tree[f"head_{i}"] for i in range(n_head)] + [
        tree_map(lambda t, g=g: t[g], tree["groups"][f"l{j}"])
        for g in range(cfg.n_groups) for j in range(glen)]
    if "enc_groups" in tree:
        out["enc_layers"] = [tree_map(lambda t, g=g: t[g],
                                      tree["enc_groups"]["l0"])
                             for g in range(cfg.n_enc_layers)]
    return out


def _paths(tree, path=()):
    """(path, leaf) of a tree of dicts; a tuple (a group's layers) is a
    leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _dense(x):
    return torch.stack(x) if isinstance(x, tuple) else x


class Optimizer:
    """Dispatch facade: ``kind`` -> module with init/update. With ``cfg``
    the state is kept in the reference's stacked layout (module
    docstring), and ``init``/``update`` run the module leaf by leaf:
    one group leaf's stacked copies live at a time."""

    def __init__(self, kind: str, state_dtype="float32", *, cfg=None,
                 **hyper):
        self.kind = kind
        self.mod = {"adamw": adamw, "adafactor": adafactor}[kind]
        self.state_dtype = (_DTYPES[state_dtype]
                            if isinstance(state_dtype, str) else state_dtype)
        self.cfg = cfg
        self.hyper = hyper

    def _leaves(self, tree):
        """(path, leaf) in the reference's layout, a group leaf as the
        tuple of its layers' tensors."""
        return _paths(_ref_layout(tree, self.cfg, tuple))

    @torch.no_grad()
    def init(self, params):
        if self.cfg is None:
            return self.mod.init(params, self.state_dtype)
        out = {}
        for path, p in self._leaves(params):
            st = self.mod.init({"x": _dense(p)}, self.state_dtype)
            for k, v in st.items():
                if k == "count":
                    out[k] = v
                else:
                    _put(out.setdefault(k, {}), path, v["x"])
        return out

    @torch.no_grad()
    def update(self, grads, state, params, *, lr, grad_scale=None):
        """New (params, state). ``grad_scale`` (the clip factor) scales
        each grad in f32 before the update, as the reference's ``g *
        scale`` in its train step."""
        def scaled(g):
            return g if grad_scale is None else g.to(torch.float32) \
                * grad_scale

        if self.cfg is None:
            return self.mod.update(tree_map(scaled, grads), state, params,
                                   lr=lr, **self.hyper)
        keys = [k for k in state if k != "count"]
        new_p, new_s = {}, {k: {} for k in state}
        p_ref = _ref_layout(params, self.cfg, tuple)
        for path, g in self._leaves(grads):
            sub = {k: {"x": _get(state[k], path)} for k in keys}
            p, st = self.mod.update(
                {"x": scaled(_dense(g))}, dict(sub, count=state["count"]),
                {"x": _dense(_get(p_ref, path))}, lr=lr, **self.hyper)
            _put(new_p, path, p["x"])
            for k in keys:
                _put(new_s[k], path, st[k]["x"])
            new_s["count"] = st["count"]
        return unstack_layers(new_p, self.cfg), new_s


def for_config(cfg, **hyper) -> Optimizer:
    return Optimizer(cfg.optimizer, cfg.opt_state_dtype, cfg=cfg, **hyper)


__all__ = ["Optimizer", "for_config", "adamw", "adafactor",
           "cosine_with_warmup", "stack_layers", "unstack_layers"]
