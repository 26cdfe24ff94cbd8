"""GPipe-style pipeline parallelism over a group of stage ranks (port of
``repro/runtime/pipeline.py``).

Each rank of ``group`` is one stage and holds its slice of the layers;
microbatches stream through with a ring hand-off (the reference's
``ppermute``: paired ``isend``/``irecv`` in one ``batch_isend_irecv``).
The schedule is GPipe's fill-drain, with ``n_stages - 1`` bubble steps.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map


def _ring(t: torch.Tensor, group, n_stages: int,
          stats: dict | None) -> torch.Tensor:
    """Send ``t`` to the next stage, return what the previous one sent."""
    if n_stages == 1:
        return t
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n_stages)
    prv = dist.get_global_rank(group, (me - 1) % n_stages)
    src = t.contiguous()
    recv = torch.empty_like(src)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, nxt, group),
        dist.P2POp(dist.irecv, recv, prv, group)])
    for r in reqs:
        r.wait()
    if stats is not None:
        stats["sent"] = stats.get("sent", 0) + src.numel() * src.element_size()
    return recv


def pipeline_forward(stage_fn, params_stacked, x_microbatches, *, group,
                     n_stages: int, stats: dict | None = None):
    """Run x through ``n_stages`` stage_fns with GPipe microbatching.

    params_stacked: pytree with leading dim n_stages (stage i's params;
    this rank, stage ``group`` rank i, uses slice i).
    x_microbatches: (n_micro, mb, ...) activations entering stage 0, the
    same on every rank. Returns (n_micro, mb, ...), the last stage's
    outputs, on every rank. ``stats``, if given, adds ``"sent"``: the
    hand-off bytes this rank sent.
    """
    if dist.get_world_size(group) != n_stages:
        raise ValueError(f"{n_stages} stages need a group of {n_stages} "
                         f"ranks, got {dist.get_world_size(group)}")
    stage = dist.get_rank(group)
    params = tree_map(lambda p: p[stage], params_stacked)
    xs = x_microbatches
    n_micro = xs.shape[0]
    buf = torch.zeros_like(xs)
    inflight = torch.zeros_like(xs[0])
    for t in range(n_micro + n_stages - 1):
        # receive from the previous stage (stage 0 injects microbatch t)
        recv = _ring(inflight, group, n_stages, stats)
        x_in = xs[min(max(t, 0), n_micro - 1)] if stage == 0 else recv
        active = 0 <= t - stage < n_micro
        y = stage_fn(params, x_in) if active else x_in
        if stage == n_stages - 1 and active:
            buf[t - (n_stages - 1)] = y
        inflight = y
    # every stage holds a buffer; the last stage's is the real one
    dist.broadcast(buf, src=dist.get_global_rank(group, n_stages - 1),
                   group=group)
    return buf
