"""Activation-sharding hints decoupled from model code (port of
``repro/runtime/hints.py``).

Model code calls ``hint(x, "hidden")`` etc.; the distributed step builder
installs a mapping kind -> spec for the active mesh. Outside a context
(unit tests, one-device runs, the serving engines) a hint returns its
argument and runs no op, so the same model code serves one device and a
mesh. Inside one, a DTensor is redistributed to the kind's spec, fitted
to its runtime shape; a plain tensor passes through. The mesh helpers
below (``per_shard``, ``lookup``, ``gather_data``, ``split_heads``,
``merge_heads``, ``gather_inner``, ``gather_inner_grad``,
``is_dtensor``) likewise read the context first and, outside one, do
the one-device op and nothing else: the serving path pays one context
read a call.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch

from .sharding import _axsize, axis_sizes, placements

_CTX = contextvars.ContextVar("shard_hints", default=None)

# kinds where a non-divisible dim may still shard in the reference (GSPMD
# pads it). DTensor would split it unevenly, and its einsums fail on such
# shards (rwkv6's 128 decode rows over 256 devices), so here such a dim
# shards over the leading axes of its entry that divide it
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
    # drop sharding on axes the runtime shape doesn't divide (e.g. the
    # sequence-parallel 'model' axis on S=1 decode steps)
    sizes = axis_sizes(mesh)
    padded = tuple(spec) + (None,) * (x.ndim - len(spec))
    if kind in PAD_OK_KINDS:
        spec = tuple(_dividing_prefix(sizes, ax, dim)
                     for dim, ax in zip(x.shape, padded))
    else:
        spec = tuple(ax if ax is not None and dim % _axsize(sizes, ax) == 0
                     else None for dim, ax in zip(x.shape, padded))
    pl = placements(mesh, spec)
    if tuple(x.placements) == tuple(pl):
        return x
    return x.redistribute(mesh, pl)


def _dividing_prefix(sizes: dict, ax, dim: int):
    """The longest leading part of a spec entry whose axes divide
    ``dim`` (``None`` if not even its first does)."""
    axes = ax if isinstance(ax, tuple) else (ax,) if ax is not None else ()
    while axes and dim % _axsize(sizes, axes):
        axes = axes[:-1]
    return None if not axes else axes[0] if len(axes) == 1 else axes


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor inside a hint context (outside one no
    mesh path runs: False)."""
    if _CTX.get() is None:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _kept(x, keep, xs) -> tuple:
    """``x``'s placements with only the shards of the tensor dims in
    ``keep`` that every one of ``xs`` divides evenly (a dim split over
    several mesh dims, by their product); the rest replicated (gathered,
    partial sums reduced)."""
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    out, split = [], {}
    for i, p in enumerate(x.placements):
        n = split.get(p.dim, 1) * mesh.size(i) if p.is_shard() else 0
        ok = p.is_shard() and p.dim in keep and all(
            t.shape[p.dim] % n == 0 for t in xs)
        if ok:
            split[p.dim] = n
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


def per_shard(fn, *xs, keep=(0,), shared=()):
    """``fn(*xs, *shared)`` on each rank's local blocks. Without a DTensor
    among ``xs`` everything goes straight to ``fn``. Else the tensors of
    ``xs`` (inputs and outputs laid out alike on the dims in ``keep``; a
    plain tensor counts as replicated) keep only the first DTensor's
    shards of those dims, every other dim gathered; a DTensor of
    ``shared`` (a param every block reads, e.g. rwkv6's ``u``) comes
    whole to every rank, its grad the sum over the ranks' blocks. ``fn``
    runs on the local blocks and its outputs come back as DTensors on
    those shards.
    For work that is independent per batch row (``keep=(0,)``: MoE's
    ``searchsorted`` dispatch plan, which DTensor has no rule for, and
    the WKV recurrence) or per row and head (attention's core, ``keep=(0,
    2)``: a flatten of a sharded head dim is refused by some versions of
    DTensor's view rules). The result is the one-device one, block for
    block."""
    if _CTX.get() is None:
        return fn(*xs, *shared)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    ref = next((x for x in xs if isinstance(x, DTensor)), None)
    if ref is None:
        return fn(*xs, *shared)
    mesh = ref.device_mesh
    pl = _kept(ref, keep, [x for x in xs if isinstance(x, DTensor)])
    sharded = any(p.is_shard() for p in pl)

    def local(x):
        if not isinstance(x, DTensor):      # implicitly replicated
            x = DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                                   run_check=False)
        t = x.redistribute(mesh, pl).to_local()
        return _ContiguousGrad.apply(t) if sharded else t

    def whole(w):
        full = w.redistribute(mesh, (Replicate(),) * mesh.ndim)
        return full.to_local(grad_placements=tuple(
            Partial() if p.is_shard() else Replicate() for p in pl))

    outs = fn(*(local(x) if isinstance(x, torch.Tensor) else x for x in xs),
              *(whole(w) if isinstance(w, DTensor) else w for w in shared))
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


def split_heads(x, n_heads: int, head_dim: int):
    """``x`` (..., n_heads * head_dim) -> (..., n_heads, head_dim). On a
    mesh, where the axes that shard ``x``'s last dim do not divide
    ``n_heads``, those shards are gathered first: a shard would end
    inside a head, and DTensor refuses that view ("Cannot unflatten
    unevenly sharded tensor"), where GSPMD reshards the same way (qwen3's
    8 kv heads, granite's 24 heads or whisper's 6 on a 16-wide model
    axis). Where they divide, each shard keeps whole heads and nothing
    moves. A plain tensor is reshaped as it is."""
    shape = (*x.shape[:-1], n_heads, head_dim)
    if _CTX.get() is None:
        return x.reshape(shape)
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x.reshape(shape)
    pl = _unaligned(x, n_heads)
    if pl != tuple(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return x.reshape(shape)


def _unaligned(x, n_heads: int) -> tuple:
    """``x``'s placements with its last dim's shards gathered where the
    axes that shard it do not divide ``n_heads``; else ``x``'s own."""
    from torch.distributed.tensor import Replicate

    last, mesh = x.ndim - 1, x.device_mesh
    split = math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                      if p.is_shard(last))
    if n_heads % split == 0:
        return tuple(x.placements)
    return tuple(Replicate() if p.is_shard(last) else p
                 for p in x.placements)


class _HeadAlignedGrad(torch.autograd.Function):
    """Identity whose backward gathers the grad's last-dim shards where
    they would end inside one of ``n_heads`` heads: the grad of
    ``merge_heads``' flatten meets the view back to heads there."""

    @staticmethod
    def forward(ctx, x, n_heads):
        ctx.n_heads = n_heads
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        if isinstance(g, DTensor):
            pl = _unaligned(g, ctx.n_heads)
            if pl != tuple(g.placements):
                g = g.redistribute(g.device_mesh, pl)
        return g, None


def merge_heads(x):
    """``x`` (..., n_heads, head_dim) -> (..., n_heads * head_dim), the
    inverse of ``split_heads``. The flatten itself never splits a head;
    its backward views the grad back into heads, so on a mesh the grad's
    shards are gathered first where they would end inside a head (a
    row-parallel projection's input grad, sharded over ``model``, with
    yi's 56 heads on 16). A plain tensor is reshaped as it is."""
    n = x.shape[-2]
    y = x.reshape(*x.shape[:-2], n * x.shape[-1])
    if _CTX.get() is None:
        return y
    from torch.distributed.tensor import DTensor

    return _HeadAlignedGrad.apply(y, n) if isinstance(y, DTensor) else y


def _inner_gathered(x):
    if x.ndim < 3:
        return x
    from torch.distributed.tensor import Replicate

    pl = tuple(Replicate() if p.is_shard() and 0 < p.dim < x.ndim - 1
               else p for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def gather_inner(x):
    """A DTensor with the shards of its inner dims (all but the first and
    the last) gathered: the sequence-parallel all-gather before a
    projection, which flattens (batch, sequence). A plain tensor passes
    through."""
    if _CTX.get() is None:
        return x
    from torch.distributed.tensor import DTensor

    return _inner_gathered(x) if isinstance(x, DTensor) else x


class _InnerGatheredGrad(torch.autograd.Function):
    """Identity whose backward is ``gather_inner`` on the grad."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        return _inner_gathered(g) if isinstance(g, DTensor) else g


def gather_inner_grad(y):
    """``y`` itself, with its grad's inner-dim shards gathered in the
    backward: a projection's output grad, sequence-sharded by the
    ``"hidden"`` hint downstream, would otherwise reach the weight's grad
    flattened over (batch, sequence) across two mesh axes, a layout
    DTensor cannot run on fake tensors (the transpose of
    ``gather_inner``). A plain tensor passes through."""
    if _CTX.get() is None:
        return y
    from torch.distributed.tensor import DTensor

    if not isinstance(y, DTensor) or not y.requires_grad:
        return y
    return _InnerGatheredGrad.apply(y)


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
