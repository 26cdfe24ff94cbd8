"""Sharding rules: parameter, activation, cache and batch specs per mesh
(port of ``repro/runtime/sharding.py``), and their DTensor placements.

Name-based rules: tensor parallelism over ``model`` (heads, ffn, experts,
vocab), FSDP-style 2-D sharding of weights and optimizer state over
(``data``, ``model``) within a pod, the batch over (``pod``, ``data``);
pods replicate the params (data parallel across pods, where the int8
gradient exchange of ``quant.gradcomp`` applies).

A spec is a tuple with one entry per tensor dim: ``None`` (replicated), a
mesh axis name, or a tuple of names (the dim split over several axes,
the first the major one), as the reference's ``PartitionSpec``. Any dim
the axis size does not divide is replicated (``_fit``; glm4's 2 kv heads,
granite's 40 experts and rwkv's 40 heads on a 16-wide model axis).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims or, for the pure spec functions, anything ``axis_sizes`` reads (a
``MeshShape``: no process group needed). ``placements(mesh, spec)`` turns
a spec into one DTensor placement per mesh dim.

The port's params hold a list of layers where the reference stacks its
scanned groups: a leaf under ``layers``/``enc_layers`` takes the core
spec, a leaf stacked on a leading group axis (under ``groups``/
``enc_groups``, the optimizer's layout: ``optim.stack_layers``) takes
``(None, *core)``, as the reference's stacked leaf does.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.tree import items, tree_map, unflatten

# ------------------------------------------------------------------ helpers


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh, without devices or processes: the
    spec functions' stand-in for a ``DeviceMesh``."""
    shape: dict


def axis_sizes(mesh) -> dict:
    """{axis name: size}, mesh dims in order, of a ``DeviceMesh`` (its
    ``mesh_dim_names``), a ``MeshShape`` or anything with a ``shape``
    mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: int(s) for n, s in zip(names, mesh.shape)}
    return {n: int(s) for n, s in dict(mesh.shape).items()}


def _axsize(sizes: dict, ax) -> int:
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        return math.prod(sizes[a] for a in ax)
    return sizes[ax]


def _fit(mesh, spec: tuple, shape) -> tuple:
    """Drop sharding on dims the shape doesn't divide evenly."""
    sizes = axis_sizes(mesh)
    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(ax if ax is not None and dim % _axsize(sizes, ax) == 0
                 else None for dim, ax in zip(shape, padded))


def placements(mesh, spec: tuple) -> tuple:
    """One DTensor placement per mesh dim: ``Shard(d)`` where the axis
    names tensor dim d, ``Replicate()`` otherwise, and on an axis of size
    1 (where a shard is the whole tensor, and DTensor's view rules would
    refuse to flatten it). A dim named by two axes shards over both;
    DTensor splits it over the mesh dims in mesh order, which is the
    spec's major-first order for every rule here. A tuple, so a tree of
    placements keeps it as one leaf."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name, size in axis_sizes(mesh).items():
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return tuple(out)


def spec_of(mesh, placement_list, ndim: int) -> tuple:
    """The inverse of ``placements`` (on a mesh with no axis of size 1):
    the spec of a list of placements."""
    per_dim = [[] for _ in range(ndim)]
    for name, p in zip(axis_sizes(mesh), placement_list):
        if p.is_shard():
            per_dim[p.dim].append(name)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in per_dim)


def _names(path: str) -> list:
    return path.split("/")


# ------------------------------------------------------------- param rules

# matched against the LAST path component; first hit wins. (in_dim-sharded
# matrices put 'data' on dim 0 = FSDP; out-dim 'model' = TP megatron split)
_PARAM_RULES_2D = {
    # (d_in, out*) column-parallel
    "wq": ("data", "model"), "wk": ("data", "model"), "wv": ("data", "model"),
    "c_wq": ("data", "model"), "c_wk": ("data", "model"),
    "c_wv": ("data", "model"),
    "w_gate": ("data", "model"), "w_up": ("data", "model"),
    "w_in": ("data", "model"), "w_r": ("data", "model"),
    "w_k": ("data", "model"),
    "w_v": ("data", "model"), "w_g": ("data", "model"),
    "c_k": ("data", "model"),
    "c_r": ("data", "model"), "w_lora_a": ("data", None),
    # (in*, d_out) row-parallel
    "wo": ("model", "data"), "c_wo": ("model", "data"),
    "w_down": ("model", "data"), "w_out": ("model", "data"),
    "w_o": ("model", "data"), "c_v": ("model", "data"),
    "w_lora_b": (None, "data"),
    # embeddings
    "embed": ("model", "data"), "lm_head": ("data", "model"),
    # mla
    "wdkv": ("data", None), "wkr": ("data", None), "wukv": (None, "model"),
    # mamba
    "w_bcdt": ("model", None), "w_dt": (None, "model"),
    "A_log": ("model", None), "conv_w": (None, "model"),
    # router: replicated (tiny, f32)
    "router": (None, None),
}
_PARAM_RULES_3D = {   # MoE expert-stacked weights: experts over 'model'
    "w_gate": ("model", "data", None), "w_up": ("model", "data", None),
    "w_down": ("model", None, "data"),
}
_PARAM_RULES_1D = {
    "dt_bias": ("model",), "D_skip": ("model",),
}


def param_spec(mesh, path: str, leaf) -> tuple:
    """The spec of the param at ``path`` (``/``-joined, e.g.
    ``layers/3/mixer/wq`` or the stacked ``groups/l0/mixer/wq``).

    As in the reference, only a path through ``groups`` counts as
    stacked: its ``enc_groups`` (whisper's encoder) are matched at their
    full rank, so their matrices replicate and their FFN stacks meet the
    MoE rule on the layer axis. The port's ``enc_layers`` replicate
    (ROADMAP C)."""
    names = _names(path)
    if "enc_layers" in names:
        return (None,) * leaf.ndim
    last = names[-1]
    stacked = "groups" in names
    core_shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
    rank = len(core_shape)
    spec = None
    if rank == 3 and last in _PARAM_RULES_3D:
        spec = _PARAM_RULES_3D[last]
    elif rank == 2 and last in _PARAM_RULES_2D:
        spec = _PARAM_RULES_2D[last]
    elif rank == 1 and last in _PARAM_RULES_1D:
        spec = _PARAM_RULES_1D[last]
    if spec is None:
        spec = (None,) * rank       # norms, biases, mix coeffs: replicate
    spec = _fit(mesh, spec, core_shape)
    return (None, *spec) if stacked else spec


def _tree_specs(fn, tree):
    return unflatten(tree, [fn(path, leaf) for path, leaf in items(tree)])


def param_specs(mesh, params) -> dict:
    """A tree of specs matching a params tree (tensors or meta tensors)."""
    return _tree_specs(lambda p, leaf: param_spec(mesh, p, leaf), params)


def param_shardings(mesh, params) -> dict:
    """A tree of placements matching a params tree."""
    return _tree_specs(
        lambda p, leaf: placements(mesh, param_spec(mesh, p, leaf)), params)


def distribute(tree, mesh, shardings):
    """Each leaf of ``tree`` (the full tensor, the same on every rank:
    seeded, or read from a checkpoint) distributed onto ``mesh`` with its
    placements: each rank keeps its shard, with no collective. A leaf
    that is already a DTensor is redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(t, pl):
        if isinstance(t, DTensor):
            return t.redistribute(mesh, pl)
        return distribute_tensor(t, mesh, pl, src_data_rank=None)

    return tree_map(one, tree, shardings)


def distribute_params(params, mesh) -> dict:
    """Full params (seeded, the same on every rank) -> DTensors on
    ``mesh`` by the param rules."""
    return distribute(params, mesh, param_shardings(mesh, params))


# ------------------------------------------------------- activations hints


def _batch_axes(mesh):
    names = axis_sizes(mesh)
    bax = tuple(a for a in ("pod", "data") if a in names)
    return bax if len(bax) > 1 else (bax[0] if bax else None)


def hint_specs(cfg, mesh) -> dict:
    """kind -> spec of the activations ``runtime.hints.hint`` constrains
    (the reference's table; its comments give each choice's reason)."""
    bax = _batch_axes(mesh)
    sizes = axis_sizes(mesh)
    msize = sizes.get("model", 1)
    kv_ok = (cfg.n_kv_heads % msize) == 0
    heads_ok = (cfg.n_heads % msize) == 0
    return {
        # sequence parallelism: the residual stream shards S over 'model';
        # hint() drops the constraint when S doesn't divide (decode S=1)
        "hidden": (bax, "model", None),
        # heads divide the model axis -> head-parallel attention;
        # otherwise context-parallel: q's sequence dim over 'model'
        "qkv": ((bax, None, "model", None) if heads_ok
                else (bax, "model", None, None)),
        "kv": (bax, None, "model" if kv_ok else None, None),
        "ffn": (bax, None, "model"),
        "logits": (bax, None, "model"),
        "moe_buf": (bax, "model", None, None),
        "moe_h": (bax, "model", None, None),
        # combine path: token(xK) dim over 'model'
        "moe_tok": (bax, "model", None),
        "ssm_inner": (bax, None, "model"),
        # rwkv wkv region: one pod shards the batch over (data x model);
        # on multi-pod pad-shard the 40 heads over 'model'
        # (hints.PAD_OK_KINDS)
        "wkv": ((("data", "model"), None, None, None)
                if "pod" not in sizes
                else (bax, None, "model", None)),
    }


# ------------------------------------------------------------- cache specs


def cache_spec(mesh, cfg, path: str, leaf, *, batch_size: int) -> tuple:
    """KV/state cache spec; when the batch is smaller than the data axis,
    the KV buffers shard their sequence dim instead (sequence-parallel
    decode). ``path`` is ``/``-joined: the port's per-layer cache list
    (``3/k``) takes the core spec, a stacked ``groups``/``cross`` leaf
    ``(None, *core)``."""
    names = _names(path)
    last = names[-1]
    # the reference's stacked groups and cross K/V; a layer of the port's
    # cache lists (a numbered path) is never stacked
    stacked = (("groups" in names or "cross" in names)
               and not any(n.isdigit() for n in names))
    core_shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
    sizes = axis_sizes(mesh)
    dsize = sizes.get("data", 1)
    msize = sizes.get("model", 1)
    batch_ok = batch_size % dsize == 0

    def heads_spec(n_heads):
        return "model" if n_heads % msize == 0 else None

    if last in ("k", "v", "k_s", "v_s"):   # (B, L, Hkv, Dh|1)
        hs = heads_spec(cfg.n_kv_heads)
        if batch_ok:
            spec = (("data", None, hs, None) if hs is not None
                    else ("data", "model", None, None))
        else:                        # batch too small: SP over everything
            spec = ((None, "data", hs, None) if hs is not None
                    else (None, ("data", "model"), None, None))
    elif last in ("ckv", "krope"):   # MLA latent (B, L, r)
        spec = (("data", "model", None) if batch_ok
                else (None, ("data", "model"), None))
    elif last == "h":                # mamba state (B, E, N)
        spec = ("data" if batch_ok else None, "model", None)
    elif last == "conv":             # (B, dc-1, E)
        spec = ("data" if batch_ok else None, None, "model")
    elif last == "s":                # rwkv state (B, H, hd, hd)
        hs = heads_spec(cfg.d_model // cfg.rwkv_head_dim)
        spec = ("data" if batch_ok else None, hs, None, None)
    elif last in ("shift_t", "shift_c"):
        spec = ("data" if batch_ok else None, None)
    else:
        spec = (None,) * len(core_shape)
    spec = _fit(mesh, spec, core_shape)
    return (None, *spec) if stacked else spec


def cache_shardings(mesh, cfg, cache, *, batch_size: int):
    """A tree of placements matching a cache tree."""
    return _tree_specs(lambda p, leaf: placements(mesh, cache_spec(
        mesh, cfg, p, leaf, batch_size=batch_size)), cache)


def batch_spec(mesh, name: str, shape) -> tuple:
    """Token/label/embed inputs: the batch dim over ('pod','data') when
    divisible; M-RoPE positions (3, B, S) on their dim 1."""
    bax = _batch_axes(mesh)
    if name == "positions" and len(shape) == 3:
        return _fit(mesh, (None, bax, None), shape)
    return _fit(mesh, (bax, *([None] * (len(shape) - 1))), shape)


def batch_shardings(mesh, batch_shapes: dict) -> dict:
    """name -> placements; ``batch_shapes`` maps each input's name to
    its shape (or to a (shape, dtype) pair, or a tensor)."""
    out = {}
    for name, v in batch_shapes.items():
        shape = v.shape if hasattr(v, "shape") else v[0]
        out[name] = placements(mesh, batch_spec(mesh, name, tuple(shape)))
    return out
