"""Per-device step accounting: FLOPs, HBM bytes, collective bytes and the
peak bytes a device holds (the counterpart of ``repro/analysis/hlo.py``,
under its name so the two module trees mirror).

There is no HLO here. The reference parses the optimized, post-SPMD HLO
of a compiled step; the port counts the ops a step dispatches, per
device, while it runs (on fake tensors in the dry run: no device and no
memory). ``with accounting(*held) as acc:`` counts what runs inside;
``acc.stats()`` returns the reference's keys ``flops``, ``hbm_bytes``,
``collective_bytes`` and ``per_collective``, and ``flops_f32``,
``n_ops``, ``peak_bytes`` and ``held_bytes``:

- The counter is a ``TorchDispatchMode`` that steps aside for DTensor
  (it returns ``NotImplemented`` where a DTensor is among the operands),
  so it sees what each rank runs: the local aten ops on its shards and
  the ``_c10d_functional`` collectives DTensor issues. The ops DTensor
  runs on global shapes to derive its outputs' metadata
  (``ShardingPropagator._propagate_tensor_meta_non_cached``) are not
  counted. A FLOP counter entered around a DTensor op would count the
  global product instead.
- FLOPs: ``torch.utils.flop_counter.flop_registry`` on the local shapes
  (matmuls, convolutions, attention); ``flops_f32`` is the part whose
  operands are f32, which the roofline prices at the f32 rate.
- Collective bytes: the operand bytes of each c10d op, by kind under the
  reference's HLO names (``all-reduce``, ``all-gather``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``, and
  ``broadcast``).
- HBM bytes: operand plus result bytes of every op that touches memory;
  views, metadata queries and allocations are skipped. Eager torch runs
  each op as its own kernel, so this is the eager step's traffic, not
  the reference's proxy of fused ops.
- Peak bytes: the storages alive during the step, by storage, with the
  tensors in ``held`` (params, optimizer state, batch, cache) alive
  from the start: the reference's ``memory.peak_estimate``.

``while_trips`` is dropped: the port's layers are a Python list, so
every layer's ops are dispatched, and counted, one by one.

``accounting(*held, record=True)`` also keeps one row per counted op, in
dispatch order (``Accounting.ops``; ``op_lines`` renders them): the op's
name, its operands' dtypes and local shapes, its FLOPs (and how many are
f32), HBM bytes, and collective kind and bytes. The rows sum to
``stats()``'s totals. It is the port's counterpart of the reference's
saved HLO text (``launch/dryrun.py --save-hlo``).
"""
from __future__ import annotations

import contextlib
import json
import threading
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# c10d op name -> the reference's HLO collective kind
_KINDS = (("reduce_scatter", "reduce-scatter"),
          ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("gather", "all-gather"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"), ("broadcast", "broadcast"),
          ("send", "collective-permute"), ("recv", "collective-permute"))
_C10D = ("_c10d_functional", "c10d", "_c10d_functional_autograd")
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "lift_fresh", "_local_scalar_dense",
               "set_", "resize_", "wait_tensor", "device", "layout"}

_LOCAL = threading.local()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write for r in rets)


def _collective_kind(func) -> str | None:
    if func.namespace not in _C10D:
        return None
    name = func._opname
    return next((k for s, k in _KINDS if s in name), None)


def _locals(t) -> list:
    """The plain tensors behind ``t``: a DTensor's local shard."""
    local = getattr(t, "_local_tensor", None)
    return [t] if local is None else _locals(local)


@contextlib.contextmanager
def _skip_meta_propagation():
    """DTensor derives an op's output metadata by running it on global
    fake tensors; those ops are not the rank's and are not counted."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    # the uncached propagation where this torch has it (the cached one
    # calls it), else the one entry
    name = next(n for n in ("_propagate_tensor_meta_non_cached",
                            "_propagate_tensor_meta")
                if hasattr(ShardingPropagator, n))
    orig = getattr(ShardingPropagator, name)

    def wrapped(self, *a, **k):
        depth = getattr(_LOCAL, "skip", 0)
        _LOCAL.skip = depth + 1
        try:
            return orig(self, *a, **k)
        finally:
            _LOCAL.skip = depth

    setattr(ShardingPropagator, name, wrapped)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


class Accounting(TorchDispatchMode):
    """The counter (module docstring); read ``stats()`` after the
    step."""

    def __init__(self, held=(), record: bool = False):
        super().__init__()
        self.ops = [] if record else None
        self.flops = 0
        self.flops_f32 = 0
        self.hbm_bytes = 0
        self.collective_bytes = 0
        self.per_collective = defaultdict(int)
        self.n_ops = 0
        self._live = {}          # id(storage) -> (weakref, nbytes)
        self.live_bytes = 0
        for t in _tensors(held):
            for lt in _locals(t):
                self._track(lt)
        self.held_bytes = self.peak_bytes = self.live_bytes

    def _track(self, t) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()

        def gone(_, key=key, n=n):
            if self._live.pop(key, None) is not None:
                self.live_bytes -= n

        self._live[key] = (weakref.ref(st, gone), n)
        self.live_bytes += n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor runs its local ops
        kwargs = kwargs or {}
        if func is torch.ops._c10d_functional.wait_tensor.default:
            # eager returns its operand; the fake kernel a new tensor,
            # which would count the collective's output twice
            return args[0]
        out = func(*args, **kwargs)
        if getattr(_LOCAL, "skip", 0) or not isinstance(
                func, torch._ops.OpOverload):
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        self.n_ops += 1
        ins = _tensors((args, kwargs))
        kind = _collective_kind(func)
        coll = f = f32 = hbm = 0
        if kind is not None:
            coll = sum(_nbytes(t) for t in ins)
            self.collective_bytes += coll
            self.per_collective[kind] += coll
        packet = func.overloadpacket
        if packet in flop_registry:
            f = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += f
            if ins and ins[0].dtype == torch.float32:
                f32 = f
                self.flops_f32 += f
        outs = _tensors(out)
        if func._opname not in _NO_TRAFFIC and not _is_view(func):
            hbm = sum(_nbytes(t) for t in ins + outs)
            self.hbm_bytes += hbm
        if self.ops is not None:
            self.ops.append((
                f"{func._schema.name}.{func._overloadname}",
                [f"{str(t.dtype).removeprefix('torch.')}"
                 f"{list(t.shape)}" for t in ins], f, f32, hbm, kind, coll))
        for t in outs:
            self._track(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def stats(self) -> dict:
        return {"flops": float(self.flops),
                "flops_f32": float(self.flops_f32),
                "hbm_bytes": float(self.hbm_bytes),
                "collective_bytes": float(self.collective_bytes),
                "per_collective": {k: float(v) for k, v in
                                   sorted(self.per_collective.items())},
                "n_ops": self.n_ops, "peak_bytes": self.peak_bytes,
                "held_bytes": self.held_bytes}


def op_lines(ops):
    """One JSON line per recorded op (``Accounting.ops``): keys ``op``,
    ``operands``, ``flops``, ``flops_f32``, ``hbm_bytes``,
    ``collective`` (a kind or null) and ``collective_bytes``."""
    keys = ("op", "operands", "flops", "flops_f32", "hbm_bytes",
            "collective", "collective_bytes")
    for row in ops:
        yield json.dumps(dict(zip(keys, row)), separators=(",", ":"))


@contextlib.contextmanager
def accounting(*held, record: bool = False):
    """Count the ops run inside, per device (module docstring); the
    tensors of ``held`` (any trees) count as alive from the start;
    ``record`` keeps a row per op (``Accounting.ops``). Yields the
    ``Accounting``; read its ``stats()`` after the block."""
    acc = Accounting(held, record=record)
    with _skip_meta_propagation(), acc:
        yield acc
