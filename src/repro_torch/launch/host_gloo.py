"""gloo for CUDA tensors, staged through host memory.

NCCL refuses two ranks on one GPU, and gloo on CUDA tensors is not
usable on the card: its point-to-point calls fail ("gloo::IoException
... writev ... Bad address"), and a sharded train step over it ends both
ranks with SIGSEGV. Ranks that share a GPU therefore join through this
``gloo_host`` backend (``register``): a Python ``ProcessGroup`` around a
CPU gloo group. Each collective copies its CUDA tensors to pinned host
buffers, runs the gloo collective there, waits for it and copies the
results back, on every call; CPU tensors go to gloo as they are (with
``register(stage_cpu=True)``, for tests on a host without a GPU, they
are staged the same way, through copies). The bytes copied each way are
counted (``bytes_staged``). A collective's
work is complete when it returns; a send or a receive completes (and a
receive copies back) in ``wait()``, so a ring of sends does not wait on
receives not yet posted.

DTensor's functional collectives reach the group from C++ under the
names PyTorch's Python process group binds
(``allgather_into_tensor_coalesced``, ``reduce_scatter_tensor_coalesced``,
``allreduce``, ...); ``torch.distributed``'s Python calls reach every
method, under the names of the PyTorch that runs (``_allgather_base``
or ``all_gather_single``, ``alltoall_base`` or ``all_to_all_single``,
...: each has both).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_STAGED = [0, 0]          # bytes device -> host, host -> device


def bytes_staged() -> tuple[int, int]:
    """(bytes copied device -> host, host -> device) by this process."""
    return tuple(_STAGED)


def _host(t, stage_cpu=False):
    """``t`` on the host: a pinned copy of a CUDA tensor (counted), a CPU
    tensor itself (a counted copy with ``stage_cpu``)."""
    if not (t.is_cuda or stage_cpu):
        return t
    _STAGED[0] += t.numel() * t.element_size()
    return _buffer(t, stage_cpu).copy_(t)


def _buffer(t, stage_cpu=False):
    """A pinned host buffer shaped as a CUDA tensor; a CPU tensor itself
    (a new one with ``stage_cpu``)."""
    if not (t.is_cuda or stage_cpu):
        return t
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)


def _back(dst, src):
    if dst is not src:
        _STAGED[1] += src.numel() * src.element_size()
        dst.copy_(src)


def _back_all(dsts, srcs):
    for d, s in zip(dsts, srcs):
        _back(d, s)


class _Done(dist._Work):
    def __init__(self, out=()):
        super().__init__()
        self._out = list(out)

    def wait(self, timeout=None):
        return True

    def is_completed(self):
        return True

    def is_success(self):
        return True

    def result(self):
        return self._out


class _InFlight(dist._Work):
    """A send or a receive: its host buffers live until ``wait``, where a
    receive copies back."""

    def __init__(self, inner, host, dev, copy_back):
        super().__init__()
        self._inner, self._host, self._dev = inner, host, dev
        self._copy_back, self._done = copy_back, False

    def wait(self, timeout=None):
        if not self._done:
            self._inner.wait()
            if self._copy_back:
                _back_all(self._dev, self._host)
            self._done = True
        return True

    def is_completed(self):
        return self._done

    def is_success(self):
        return True

    def result(self):
        return self._dev


class HostStagedGloo(dist.ProcessGroup):
    """A CPU gloo group serving CUDA tensors through host memory."""

    _name = _desc = ""

    def __init__(self, store, rank, size, timeout, stage_cpu=False):
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)
        self._cpu = stage_cpu

    def _host(self, t):
        return _host(t, self._cpu)

    def _buffer(self, t):
        return _buffer(t, self._cpu)

    def getBackendName(self):
        return "gloo_host"

    def getGroupName(self):
        return self._name

    def setGroupName(self, name):
        self._name = name

    def getGroupDesc(self):
        return self._desc

    def setGroupDesc(self, desc):
        self._desc = desc

    def _inplace(self, op, tensors, *args):
        h = [self._host(t) for t in tensors]
        getattr(self._gloo, op)(h, *args).wait()
        _back_all(tensors, h)
        return _Done(tensors)

    def broadcast(self, tensors, opts):
        return self._inplace("broadcast", tensors, opts)

    def allreduce(self, tensors, opts):
        return self._inplace("allreduce", tensors, opts)

    def allreduce_coalesced(self, tensors, opts):
        return self._inplace("allreduce_coalesced", tensors, opts)

    def reduce(self, tensors, opts):
        return self._inplace("reduce", tensors, opts)

    def _lists(self, op, outputs, inputs, opts):
        """A collective from a list of tensors to lists of tensors."""
        hout = [[self._buffer(t) for t in ts] for ts in outputs]
        getattr(self._gloo, op)(hout, [self._host(t) for t in inputs],
                                opts).wait()
        for ts, hs in zip(outputs, hout):
            _back_all(ts, hs)
        return _Done()

    def allgather(self, outputs, inputs, opts):
        return self._lists("allgather", outputs, inputs, opts)

    def gather(self, outputs, inputs, opts):
        return self._lists("gather", outputs, inputs, opts)

    def _flat(self, op, outputs, inputs, opts, *args):
        """A collective from tensors to tensors, one pair at a time."""
        for o, i in zip(outputs, inputs):
            h = self._buffer(o)
            getattr(self._gloo, op)(h, self._host(i), *args, opts).wait()
            _back(o, h)
        return _Done(outputs)

    def _allgather_base(self, output, input, opts):
        return self._flat("_allgather_base", [output], [input], opts)

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts):
        return self._flat("_allgather_base", outputs, inputs, opts)

    all_gather_single = _allgather_base
    all_gather_single_coalesced = allgather_into_tensor_coalesced

    def _reduce_scatter_base(self, output, input, opts):
        return self._flat("_reduce_scatter_base", [output], [input], opts)

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts):
        return self._flat("_reduce_scatter_base", outputs, inputs, opts)

    reduce_scatter_single = _reduce_scatter_base
    reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced

    def _to_list(self, op, outputs, inputs, opts):
        """A collective from lists of tensors to a list of tensors."""
        hout = [self._buffer(t) for t in outputs]
        getattr(self._gloo, op)(hout, [[self._host(t) for t in ts]
                                       for ts in inputs], opts).wait()
        _back_all(outputs, hout)
        return _Done(outputs)

    def reduce_scatter(self, outputs, inputs, opts):
        return self._to_list("reduce_scatter", outputs, inputs, opts)

    def scatter(self, outputs, inputs, opts):
        return self._to_list("scatter", outputs, inputs, opts)

    def alltoall_base(self, output, input, output_splits, input_splits,
                      opts):
        h = self._buffer(output)
        self._gloo.alltoall_base(h, self._host(input), output_splits,
                                 input_splits, opts).wait()
        _back(output, h)
        return _Done([output])

    all_to_all_single = alltoall_base

    def alltoall(self, outputs, inputs, opts):
        hout = [self._buffer(t) for t in outputs]
        self._gloo.alltoall(hout, [self._host(t) for t in inputs],
                            opts).wait()
        _back_all(outputs, hout)
        return _Done(outputs)

    def barrier(self, opts):
        self._gloo.barrier(opts).wait()
        return _Done()

    def send(self, tensors, dst, tag):
        h = [self._host(t) for t in tensors]
        return _InFlight(self._gloo.send(h, dst, tag), h, tensors, False)

    def recv(self, tensors, src, tag):
        h = [self._buffer(t) for t in tensors]
        return _InFlight(self._gloo.recv(h, src, tag), h, tensors, True)


def register(stage_cpu: bool = False) -> str:
    """Register the ``gloo_host`` backend (once; ``gloo_host_cpu`` with
    ``stage_cpu``); its name."""
    name = "gloo_host_cpu" if stage_cpu else "gloo_host"
    if name.upper() not in dist.Backend._plugins:
        dist.Backend.register_backend(
            name, lambda store, rank, size, timeout: HostStagedGloo(
                store, rank, size, timeout, stage_cpu),
            devices=["cpu", "cuda"])
    return name
