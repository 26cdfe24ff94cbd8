"""Activation-sharding hints decoupled from model code (port of
``repro/runtime/hints.py``).

Model code calls ``hint(x, "hidden")`` etc.; the distributed step builder
installs a mapping kind -> spec for the active mesh. Outside a context
(unit tests, one-device runs, the serving engines) a hint returns its
argument and runs no op, so the same model code serves one device and a
mesh. Inside one, a DTensor is redistributed to the kind's spec, fitted
to its runtime shape; a plain tensor passes through. The mesh helpers
below (``per_shard``, ``lookup``, ``gather_data``, ``gather_inner``,
``is_dtensor``) likewise read the context first and, outside one, do
the one-device op and nothing else: the serving path pays one context
read a call.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from .sharding import _axsize, axis_sizes, placements

_CTX = contextvars.ContextVar("shard_hints", default=None)

# kinds where a non-divisible dim may still shard (DTensor shards it
# unevenly, as GSPMD pads it)
PAD_OK_KINDS = frozenset({"wkv"})


@contextlib.contextmanager
def hint_context(mesh, specs: dict):
    tok = _CTX.set((mesh, specs))
    try:
        yield
    finally:
        _CTX.reset(tok)


def model_axis_size() -> int:
    ctx = _CTX.get()
    if ctx is None:
        return 1
    return int(axis_sizes(ctx[0]).get("model", 1))


def hint(x, kind: str):
    ctx = _CTX.get()
    if ctx is None:
        return x
    mesh, specs = ctx
    spec = specs.get(kind)
    from torch.distributed.tensor import DTensor

    if spec is None or not isinstance(x, DTensor):
        return x
    if kind not in PAD_OK_KINDS:
        # drop sharding on axes the runtime shape doesn't divide (e.g. the
        # sequence-parallel 'model' axis on S=1 decode steps)
        sizes = axis_sizes(mesh)
        padded = tuple(spec) + (None,) * (x.ndim - len(spec))
        spec = tuple(ax if ax is not None and dim % _axsize(sizes, ax) == 0
                     else None for dim, ax in zip(x.shape, padded))
    pl = placements(mesh, spec)
    if tuple(x.placements) == tuple(pl):
        return x
    return x.redistribute(mesh, pl)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor inside a hint context (outside one no
    mesh path runs: False)."""
    if _CTX.get() is None:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _kept(x, keep, xs) -> tuple:
    """``x``'s placements with only the shards of the tensor dims in
    ``keep`` that every one of ``xs`` divides evenly; the rest
    replicated (gathered, partial sums reduced)."""
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    out = []
    for i, p in enumerate(x.placements):
        ok = p.is_shard() and p.dim in keep and all(
            t.shape[p.dim] % mesh.size(i) == 0 for t in xs)
        out.append(p if ok else Replicate())
    return tuple(out)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the grad contiguous: a local grad
    laid out otherwise (an einsum's backward permutes) would meet
    DTensor's views of its shard. Used only where a dim is sharded: a
    replicated block keeps the one-device layout, and its bits."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def per_shard(fn, *xs, keep=(0,)):
    """``fn(*xs)`` on each rank's local blocks. Plain tensors go straight
    to ``fn``. DTensors (inputs and outputs laid out alike on the dims in
    ``keep``) keep only the first input's shards of those dims, every
    other dim gathered; ``fn`` runs on the local blocks and its outputs
    come back as DTensors on those shards. For work that is independent
    per batch row (``keep=(0,)``: MoE's ``searchsorted`` dispatch plan,
    which DTensor has no rule for) or per row and head (attention's
    core, ``keep=(0, 2)``: a flatten of a sharded head dim is refused by
    some versions of DTensor's view rules). The result is the one-device
    one, block for block."""
    if _CTX.get() is None:
        return fn(*xs)
    from torch.distributed.tensor import DTensor

    ref = next((x for x in xs if isinstance(x, DTensor)), None)
    if ref is None:
        return fn(*xs)
    mesh = ref.device_mesh
    pl = _kept(ref, keep, [x for x in xs if isinstance(x, DTensor)])
    sharded = any(p.is_shard() for p in pl)

    def local(x):
        t = x.redistribute(mesh, pl).to_local()
        return _ContiguousGrad.apply(t) if sharded else t

    outs = fn(*(local(x) if isinstance(x, DTensor) else x for x in xs))
    wrap = (lambda o: DTensor.from_local(o.contiguous(), mesh, pl,
                                         run_check=False))
    return tuple(wrap(o) for o in outs) if isinstance(outs, tuple) \
        else wrap(outs)


def lookup(table, ids):
    """``table[ids]``. On a mesh: the table gathered whole on every rank,
    each rank looking up its own batch rows of ``ids`` (a plain ``ids``
    counts as replicated); the table's grad is a partial sum over the
    ranks that hold different rows, reduced back onto the table's shards.
    The one-device gather and its backward, row for row (DTensor's own
    ``index``/``index_put`` rules differ between versions, and one
    fails on the card's)."""
    if _CTX.get() is None:
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(table, DTensor):
        return table[ids.to_local() if isinstance(ids, DTensor) else ids]
    mesh = table.device_mesh
    if isinstance(ids, DTensor):
        pl = _kept(ids, (0,), [ids])
        ids = ids.redistribute(mesh, pl).to_local()
    else:
        pl = (Replicate(),) * mesh.ndim
    full = table.redistribute(mesh, (Replicate(),) * mesh.ndim)
    grad_pl = tuple(Partial() if p.is_shard() else Replicate() for p in pl)
    out = full.to_local(grad_placements=grad_pl)[ids]
    return DTensor.from_local(out.contiguous(), mesh, pl, run_check=False)


def gather_data(w):
    """A DTensor weight with its shards over every mesh axis but
    ``model`` gathered: FSDP's all-gather before use (the weight's
    ``data`` shards), tensor-parallel shards kept. Its backward
    reduce-scatters the grad back onto those shards. Without it DTensor
    may move the (larger) activations instead. A plain tensor passes
    through."""
    if _CTX.get() is None:
        return w
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names or ()
    pl = tuple(p if (i < len(names) and names[i] == "model") or
               not p.is_shard() else Replicate()
               for i, p in enumerate(w.placements))
    return w if pl == tuple(w.placements) else w.redistribute(
        w.device_mesh, pl)


def gather_inner(x):
    """A DTensor with the shards of its inner dims (all but the first and
    the last) gathered: the sequence-parallel all-gather before a
    projection, which flattens (batch, sequence). A plain tensor passes
    through."""
    if _CTX.get() is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor) or x.ndim < 3:
        return x
    pl = tuple(Replicate() if p.is_shard() and 0 < p.dim < x.ndim - 1
               else p for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def checkpoint_context_fn(base=None):
    """A ``torch.utils.checkpoint`` ``context_fn`` that recomputes under
    the hint context active now (and DTensor's implicit replication):
    autograd recomputes a checkpointed region on its device thread, where
    this thread's context variables are unset. ``base`` (a context_fn,
    e.g. a selective-checkpoint policy's) is kept. Outside a context:
    ``base`` itself."""
    ctx = _CTX.get()
    if ctx is None:
        return base

    def context_fn():
        fwd, rec = base() if base is not None else (
            contextlib.nullcontext(), contextlib.nullcontext())
        return fwd, _recompute(rec, ctx)

    return context_fn


@contextlib.contextmanager
def _recompute(rec, ctx):
    """Entered when the recompute starts: ``rec``, the hint context, and
    implicit replication unless it is on already (a process-wide flag in
    some versions of DTensor, which leaving it here would clear)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    on = DTensor._op_dispatcher._allow_implicit_replication
    with rec, hint_context(*ctx), (contextlib.nullcontext() if on
                                   else implicit_replication()):
        yield


def current_mesh():
    ctx = _CTX.get()
    return None if ctx is None else ctx[0]
