"""Quantized cross-pod gradient all-reduce with error feedback (port of
``repro/quant/gradcomp.py``).

The paper's thesis, scalar quantization as cheap value sharing, applied
to training traffic: pods train data-parallel, and the cross-pod gradient
exchange moves int8 codes plus one f32 scale per tensor instead of bf16
or f32 values (2-4x fewer bytes). Error feedback (Seide et al.) keeps the
quantization residual locally, so the compression bias vanishes over
steps.

The pod axis stays outside DTensor's reach: each pod runs the train step
on its own ``("data", "model")`` sub-mesh on its slice of the batch (were
the step on the whole mesh, DTensor would all-reduce the gradients over
the pods in full precision). Each rank then exchanges its shard of every
gradient with the ranks of the same (data, model) coordinate in the other
pods, over the pod group: the reference's manual ``shard_map`` over
``pod`` alone. The scale is the max over the whole gradient (its shards
reduced over the sub-mesh), so the codes are those of the whole tensor.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import items, tree_map, unflatten


def _quantize_int8(g):
    """Symmetric uniform int8 scalar quantization: scale max|g| / 127
    (floored at 1e-20), codes rounded half to even and clipped to 127.
    Both divisions are IEEE divisions, as the reference's: a Python-scalar
    divisor would make CUDA multiply by its reciprocal, an ulp off for
    some maxima."""
    m = torch.clamp(torch.max(torch.abs(g)), min=1e-20)
    scale = m / torch.full((), 127.0, dtype=m.dtype, device=m.device)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q, scale):
    return q.to(torch.float32) * scale


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _like(local, ref):
    """``local`` as a DTensor placed as ``ref`` (a plain tensor as is)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(ref, DTensor):
        return local
    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def _all_gather(t, group):
    """(n, *t.shape): ``t`` from every rank of ``group``."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.stack(out)


def pod_quantized_allreduce(grads, err, *, group, stats: dict | None = None):
    """Per-pod partial grads -> the same mean grads on every pod, and the
    new error-feedback state. ``group``: the pod group (this rank and its
    peers at the same sub-mesh coordinate). ``stats``, if given, adds
    ``"bytes"`` (this rank's codes + scales sent), ``"bytes_grad_dtype"``
    and ``"bytes_f32"`` (the same tensors uncompressed)."""
    n_pods = dist.get_world_size(group)

    def one(g, e):
        if any(p.is_partial() for p in getattr(g, "placements", ())):
            raise ValueError("pod_quantized_allreduce: a grad holds partial "
                             "sums; place it as its param first")
        g32 = g.to(torch.float32) + e
        q, scale = _quantize_int8(g32)
        deq = _dequantize(q, scale)
        new_e = g32 - deq
        # the scale is the whole tensor's (a max over the sub-mesh's
        # shards); the codes are this rank's shard of the whole tensor's
        ql = _local(q)
        sl = scale.full_tensor() if hasattr(scale, "full_tensor") else scale
        qs = _all_gather(ql, group)                 # int8 over the wire
        ss = _all_gather(sl, group)
        total = torch.tensordot(ss, qs.to(torch.float32), dims=([0], [0]))
        if stats is not None:
            stats["bytes"] = stats.get("bytes", 0) + ql.numel() + 4
            stats["bytes_grad_dtype"] = (stats.get("bytes_grad_dtype", 0)
                                         + ql.numel() * g.element_size())
            stats["bytes_f32"] = stats.get("bytes_f32", 0) + ql.numel() * 4
        mean = total / torch.full((), n_pods, dtype=total.dtype,
                                  device=total.device)
        return _like(mean.to(g.dtype), g), new_e

    flat_g = items(grads)
    out = [one(g, e) for (_, g), e in zip(flat_g, _leaves_like(err, grads))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))


def _leaves_like(tree, like):
    """The leaves of ``tree`` in ``like``'s order."""
    return [leaf for _, leaf in items(tree_map(lambda _, t: t, like, tree))]


def init_error_feedback(params):
    """Zero f32 error state shaped (and, for DTensors, placed) like
    ``params``."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def wrap_pod_train_step(train_step_core, mesh, *, group=None):
    """Lift a per-pod step into a multi-pod one with the compressed
    cross-pod gradient exchange.

    ``mesh``: a ``DeviceMesh`` with dims ``("pod", "data", "model")``.
    ``train_step_core(state, batch) -> (grads, metrics)`` runs on this
    pod's ``mesh["data", "model"]`` sub-mesh (its state placed there);
    the caller applies the optimizer after the exchange, so every pod
    stays identical. Returns ``stepped(state, err, batch) -> (grads,
    new_err, metrics)``: ``batch`` is the global batch (the same on every
    rank), of which this pod takes its rows (batch dim 0 over ``pod``);
    the metrics are averaged over the pods."""
    if "pod" not in (mesh.mesh_dim_names or ()):
        raise ValueError("wrap_pod_train_step needs a 'pod' mesh axis")
    pod_group = group or mesh.get_group("pod")
    n_pods = mesh.size(mesh.mesh_dim_names.index("pod"))
    pod = mesh.get_local_rank("pod")

    def stepped(state, err, batch, stats=None):
        rows = {k: v.chunk(n_pods, dim=_batch_dim(k, v))[pod]
                for k, v in batch.items()}
        grads, metrics = train_step_core(state, rows)
        grads, new_err = pod_quantized_allreduce(grads, err, group=pod_group,
                                                 stats=stats)
        out = {}
        for k, v in metrics.items():
            v = (v.full_tensor() if hasattr(v, "full_tensor") else v)
            v = v.detach().clone()
            dist.all_reduce(v, group=pod_group)
            out[k] = v / n_pods
        return grads, new_err, out

    return stepped


def _batch_dim(name: str, t) -> int:
    """M-RoPE positions (3, B, S) carry the batch on dim 1."""
    return 1 if name == "positions" and t.ndim == 3 else 0
