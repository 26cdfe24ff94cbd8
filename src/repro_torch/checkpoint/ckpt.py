"""Atomic, optionally asynchronous checkpoints in the reference's layout
with reshard-on-load (port of ``repro/checkpoint/ckpt.py``).

Layout: ``<dir>/step_<N>/`` holds one ``.npy`` per leaf and
``manifest.json`` ({"step", "tree": {key: {"file", "shape", "dtype"}},
"time"}), keyed by the leaf's path joined with ``::``. A checkpoint is
written to ``step_<N>.tmp`` and renamed (an atomic publish); ``keep_last``
prunes older steps. bf16 leaves are stored as their uint16 bits under the
manifest dtype ``"bfloat16"`` (no ``ml_dtypes`` needed) and come back
bitwise. The two packages read each other's checkpoints of every other
dtype.

A sharded state (DTensor leaves on a mesh) is gathered to full tensors on
every rank in the caller's thread; rank 0 writes, and every rank waits
for the write at a barrier (``save`` returns after it, or the handle's
``join`` does). The files are the one-device files, so a checkpoint
written on a mesh restores on one device and the other way round;
``restore(shardings=)`` distributes each leaf onto the current mesh,
whatever its size (reshard-on-load).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.tree import items, unflatten

_SEP = "::"


def _flatten(tree) -> dict:
    return dict(items(tree, _SEP))


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    if hasattr(t, "full_tensor"):       # a DTensor: gathered on every rank
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _ranks() -> tuple[int, bool]:
    """(this rank, whether a process group of several ranks is up)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.get_rank(), True
    return 0, False


class _Pending:
    """An asynchronous save on a process group: ``join`` waits for rank
    0's writer thread, then every rank meets at a barrier."""

    def __init__(self, thread):
        self.thread = thread

    def join(self, timeout=None):
        import torch.distributed as dist

        if self.thread is not None:
            self.thread.join(timeout)
        dist.barrier()


def save(state, directory: str, step: int, *, keep_last: int = 3,
         async_: bool = False, log: list | None = None):
    """Write a checkpoint. async_=True returns a handle (join to wait):
    the writer thread on one device, a ``_Pending`` on a process group.
    ``log``, if given, gets {"step", "bytes", "host_s", "write_s"} once
    the checkpoint is published (on the writing rank)."""
    # to the host in the caller's thread; the disk I/O off its path
    t0 = time.perf_counter()
    flat = {k: _to_host(v) for k, v in _flatten(state).items()}
    host_s = time.perf_counter() - t0
    rank, multi = _ranks()

    def _write():
        t1 = time.perf_counter()
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {}
        for key, (arr, dtype) in flat.items():
            fname = f"{len(manifest)}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest[key] = {"file": fname, "shape": list(arr.shape),
                             "dtype": dtype}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "tree": manifest, "time": time.time()},
                      f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic publish
        _prune(directory, keep_last)
        if log is not None:
            log.append({"step": step, "host_s": host_s,
                        "write_s": time.perf_counter() - t1,
                        "bytes": sum(a.nbytes for a, _ in flat.values())})

    if multi:
        thread = None
        if rank == 0:
            thread = threading.Thread(target=_write, daemon=True)
            thread.start()
        pending = _Pending(thread)
        if async_:
            return pending
        pending.join()
        return None
    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _prune(directory: str, keep_last: int):
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, "manifest.json"))]
    return max(steps) if steps else None


def restore(like_tree, directory: str, *, step: int | None = None,
            shardings=None, mesh=None):
    """Load into the structure of ``like_tree``: the same leaf keys and
    shapes, each leaf cast to its like's dtype on its like's device.
    ``shardings``: a matching tree of DTensor placements; each leaf is
    then distributed onto ``mesh`` (default: the mesh of ``like_tree``'s
    first DTensor leaf) whatever its size: reshard-on-load. Every rank
    reads the files. Returns (tree, step)."""
    flat_sh = {}
    if shardings is not None:
        flat_sh = _flatten(shardings)
        flat_like = _flatten(like_tree)
        if set(flat_sh) != set(flat_like):
            raise ValueError("restore: shardings/tree mismatch: "
                             f"{sorted(set(flat_sh) ^ set(flat_like))[:4]}")
        mesh = mesh or next((t.device_mesh for t in flat_like.values()
                             if hasattr(t, "device_mesh")), None)
        if mesh is None:
            raise ValueError("restore(shardings=): no mesh given and no "
                             "DTensor in the tree to take one from")
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)["tree"]

    flat_like = _flatten(like_tree)
    missing = set(flat_like) - set(manifest)
    extra = set(manifest) - set(flat_like)
    if missing or extra:
        raise ValueError(f"checkpoint/tree mismatch: missing="
                         f"{sorted(missing)[:4]} extra={sorted(extra)[:4]}")
    out = []
    for key, like in flat_like.items():
        meta = manifest[key]
        arr = np.load(os.path.join(d, meta["file"]))
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{key}: ckpt {arr.shape} != expected "
                             f"{tuple(like.shape)}")
        if meta["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        dev = like.to_local().device if hasattr(like, "to_local") \
            else like.device
        t = t.to(device=dev, dtype=like.dtype)
        if key in flat_sh:
            t = _distribute(t, mesh, flat_sh[key])
        out.append(t)
    return unflatten(like_tree, out), step


def _distribute(t, mesh, placements):
    """``t`` (the same full tensor on every rank) onto ``mesh``: each rank
    keeps its shard, with no collective."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements, src_data_rank=None)
