"""Device meshes and the ranks behind them (port of
``repro/launch/mesh.py``).

``make_host_mesh(data, model, pod=)`` builds a ``DeviceMesh`` with named
dims ``("data", "model")``, or ``("pod", "data", "model")`` with a pod
axis, over the default process group, which the caller joins first:

- ``join(device)`` under ``torchrun`` (it reads ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK`` and the rendezvous address from the environment);
- ``spawn(fn, nprocs, *args, device=)`` otherwise: it starts the ranks
  itself, joined through a ``FileStore`` in a temporary directory (no
  TCP port: several of these may run at once), runs ``fn(*args)`` on
  each and returns their results in rank order; inside, ``regroup``
  moves a rank into another group.

Rank r computes on ``rank_device(device)``: ``cuda:(LOCAL_RANK %
device_count)``, or the CPU only when asked (``device="cpu"``). The
backend is NCCL when each rank has a GPU of its own and gloo when ranks
share one (NCCL refuses two ranks on one device) or run on the CPU.
gloo on CUDA tensors is not usable on the card (``host_gloo`` says how
it fails), so ranks that share a GPU join through that module's
``gloo_host`` backend: every collective on a CUDA tensor is staged
through host memory around a CPU gloo collective, explicitly, on every
call, its bytes counted (``host_bytes``).

``make_production_mesh(multi_pod=)`` is the dry run's mesh: (16, 16) on
("data", "model"), or (2, 16, 16) with a pod axis, over a default group
of 256 or 512 ranks, which ``join_fake(n)`` makes in one process (a
fake process group: collectives return at once and move nothing). Its
device type is ``"cpu"``: a fake step needs no device, and a CUDA mesh
cannot be built without a GPU. The dry run counts the op sequence of the
CUDA step all the same: the one branch on the device type under a
step's models and train code, ``quant.serve.qmatmul``'s dense fallback
for a stacked QuantizedTensor on the CPU, is not on a step's path (its
weights are dense).
"""
from __future__ import annotations

import math
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def _local() -> tuple[int, int]:
    """(local rank, ranks on this host) from the environment."""
    rank = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
    n = int(os.environ.get("LOCAL_WORLD_SIZE",
                           os.environ.get("WORLD_SIZE", 1)))
    return rank, n


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK % device_count)`` for
    ``"cuda"`` (raises without a GPU), the CPU for ``"cpu"``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", _local()[0] % torch.cuda.device_count())


def backend_for(device="cuda", local_ranks: int | None = None) -> str:
    """NCCL when each of this host's ranks has a GPU of its own, gloo when
    they share one or compute on the CPU."""
    dev = resolve_device(device)
    n = _local()[1] if local_ranks is None else local_ranks
    if dev.type == "cuda" and n <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def host_bytes() -> tuple[int, int]:
    """(bytes staged device -> host, host -> device) by this process's
    host-staged collectives."""
    from repro_torch.launch.host_gloo import bytes_staged

    return bytes_staged()


def _init(backend: str, dev: torch.device, **kw):
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend == "nccl":
        kw["device_id"] = dev
    elif dev.type == "cuda":       # gloo for CUDA tensors: host-staged
        from repro_torch.launch.host_gloo import register

        backend = register()
    dist.init_process_group(backend, **kw)


def join(device="cuda") -> torch.device:
    """Join the default process group from the environment ``torchrun``
    sets; prints the backend on rank 0. Returns this rank's device."""
    dev = rank_device(device)
    backend = backend_for(device)
    _init(backend, dev, init_method="env://")
    if dist.get_rank() == 0:
        print(f"[mesh] {dist.get_world_size()} ranks, backend={backend}, "
              f"device={dev.type}", flush=True)
    return dev


def regroup(store_path: str, rank: int, size: int, device="cuda"):
    """Leave the default process group (if any) and join a new one of
    ``size`` ranks through a ``FileStore`` at ``store_path``, as ``rank``
    of it (every member passes the same path). The backend is
    ``backend_for(device, size)``: a group of one rank on a GPU is NCCL.
    One set of spawned processes can so run groups of different sizes
    one after another and pay each process's start once."""
    dev = rank_device(device)
    if dist.is_initialized():
        dist.destroy_process_group()
    _init(backend_for(device, size), dev,
          store=dist.FileStore(store_path, size), rank=rank,
          world_size=size)


def _rank_main(fn, args, rank, nprocs, device, tmp):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(nprocs),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nprocs))
    try:
        dev = rank_device(device)
        if dev.type == "cpu":
            torch.set_num_threads(1)   # nprocs ranks share the host's cores
        store = dist.FileStore(os.path.join(tmp, "store"), nprocs)
        _init(backend_for(device, nprocs), dev, store=store, rank=rank,
              world_size=nprocs)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(tmp, f"out_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(tmp, f"err_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn, nprocs: int, *args, device="cuda", timeout: float = 1800.0):
    """Run ``fn(*args)`` on ``nprocs`` new ranks that join one process
    group (backend by ``backend_for``; rank 0 prints it) and return the
    results in rank order. ``fn`` and its arguments and results must
    pickle (``fn`` by import path). When a rank fails, the others are
    stopped and its traceback is raised here."""
    import multiprocessing

    rank_device(device)                  # fails here, not in the ranks
    print(f"[mesh] spawning {nprocs} ranks, backend="
          f"{backend_for(device, nprocs)}, device={torch.device(device).type}",
          flush=True)
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, args, r, nprocs, device, tmp))
             for r in range(nprocs)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=30)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            errs = [os.path.join(tmp, f"err_{r}.txt") for r in failed]
            text = next((open(e).read() for e in errs if os.path.exists(e)),
                        f"exit codes {[procs[r].exitcode for r in failed]}")
            raise RuntimeError(f"rank(s) {failed} of {nprocs} failed:\n{text}")
        out = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"out_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)


def make_host_mesh(data: int = 1, model: int = 1, *, pod: int | None = None,
                   device_type: str = "cuda"):
    """A ``DeviceMesh`` over the joined ranks: ``(data, model)``, or
    ``(pod, data, model)`` with a pod axis; its size must equal the world
    size."""
    from torch.distributed.device_mesh import init_device_mesh

    if pod is None:
        return init_device_mesh(device_type, (data, model),
                                mesh_dim_names=("data", "model"))
    return init_device_mesh(device_type, (pod, data, model),
                            mesh_dim_names=("pod", "data", "model"))


def join_fake(n: int) -> None:
    """Make this process the one rank of a fake default process group of
    ``n`` ranks (backend ``"fake"``): a mesh over it shards as a mesh of
    ``n`` devices would, and its collectives return at once. What the
    dry run joins first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 = 256 devices a pod; ``multi_pod`` stacks 2 pods -> 512,
    on a ``"cpu"`` mesh over the default group (module docstring)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(
            f"mesh {shape} needs a process group of {n} ranks, have {have}; "
            f"the dry run must first join one: "
            f"repro_torch.launch.mesh.join_fake({n})")
    if multi_pod:
        return make_host_mesh(16, 16, pod=2, device_type="cpu")
    return make_host_mesh(16, 16, device_type="cpu")


def batch_axes(mesh) -> tuple:
    """Axes the global batch shards over: ('pod','data') on multi-pod."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
