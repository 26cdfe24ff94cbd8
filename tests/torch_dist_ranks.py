"""Rank bodies for ``tests/test_torch_distributed.py`` and
``tests/test_torch_sharding.py``: each runs on every rank of a
``repro_torch.launch.mesh.spawn`` group (gloo on the CPU) and returns
numpy results from rank 0 (``None`` from the others). Kept apart from
the test files so the ranks import torch and the port only, never
jax."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import models
from repro_torch.configs import get_reduced_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import stack_layers
from repro_torch.runtime.sharding import distribute, distribute_params
from repro_torch.train.step import (distribute_batch,
                                    make_decode_step, make_prefill_step,
                                    make_train_step, on_mesh, placed_as,
                                    train_state_specs, value_and_grad)
from repro_torch.tree import items, tree_map


def small_cfg(arch):
    """The reference's ``tests/test_distributed.py:_small_cfg``: dims that
    divide a 4-wide model axis."""
    return dataclasses.replace(get_reduced_config(arch), d_model=64,
                               n_heads=4, n_kv_heads=4, head_dim=16,
                               d_ff=128, vocab=512)


def _full_np(tree) -> dict:
    """``/``-path -> numpy of each leaf's full tensor (a collective on
    DTensor leaves: every rank calls it)."""
    out = {}
    for k, v in items(tree):
        if hasattr(v, "full_tensor"):
            v = v.full_tensor()
        out[k] = v.detach().float().numpy()
    return out


def _rank0(x):
    return x if dist.get_rank() == 0 else None


def train_steps(arch, shape, ref_params, batches, lr):
    """The sharded train step on a ``shape`` mesh from the reference's
    params, one step per batch. Returns the metrics of each step and the
    params (the reference's stacked layout) and optimizer state after
    the last."""
    cfg = small_cfg(arch)
    mesh = make_host_mesh(*shape, device_type="cpu")
    if mesh.size() < dist.get_world_size():
        raise ValueError(f"mesh {shape} does not span the group")
    step, opt = make_train_step(cfg, mesh, lr=lr)
    params = models.params_from_reference(ref_params, cfg, "cpu")
    _, shard = train_state_specs(cfg, mesh, opt)
    state = distribute({"params": params, "opt": opt.init(params),
                              "step": torch.zeros((), dtype=torch.int32)},
                             mesh, shard)
    metrics = []
    for b in batches:
        batch = distribute_batch({k: torch.from_numpy(v)
                                  for k, v in b.items()}, mesh)
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    placed = [(k, tuple(v.placements)) for k, v in items(state["params"])]
    out = {"metrics": metrics, "step": int(state["step"]),
           "params": _full_np(stack_layers(state["params"], cfg)),
           "opt": _full_np(state["opt"]), "placements": placed}
    return _rank0(out)


def uneven_heads_cfg():
    """qwen3 at the test's dims but with 6 query and 2 kv heads: neither
    count divides a 4-wide model axis, though the projections' widths
    (96 and 32) do, so their shards end inside a head."""
    return dataclasses.replace(small_cfg("qwen3_0_6b"), n_heads=6,
                               n_kv_heads=2)


def train_steps_uneven_heads(shape, batches, lr):
    """The sharded train step of ``uneven_heads_cfg`` on a ``shape`` mesh
    from seeded params; the metrics and params as ``train_steps``. A
    failure comes back as its traceback (the group runs on)."""
    import traceback

    cfg = uneven_heads_cfg()
    try:
        mesh = make_host_mesh(*shape, device_type="cpu")
        step, opt = make_train_step(cfg, mesh, lr=lr)
        params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
        _, shard = train_state_specs(cfg, mesh, opt)
        state = distribute({"params": params, "opt": opt.init(params),
                            "step": torch.zeros((), dtype=torch.int32)},
                           mesh, shard)
        metrics = []
        for b in batches:
            batch = distribute_batch({k: torch.from_numpy(v)
                                      for k, v in b.items()}, mesh)
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        out = {"metrics": metrics,
               "params": _full_np(stack_layers(state["params"], cfg))}
    except Exception:
        out = {"error": traceback.format_exc()[-3000:]}
    return _rank0(out)


def decode(arch, shape, ref_params, prompt, n_steps):
    """Prefill ``prompt`` (B, S0) into a (B, S0 + n_steps) cache, then
    ``n_steps`` greedy decode steps, on the mesh and on one device.
    Returns the logits of each (prefill's last position, then each
    step) for both."""
    cfg = small_cfg(arch)
    mesh = make_host_mesh(*shape, device_type="cpu")
    params = models.params_from_reference(ref_params, cfg, "cpu")
    B, S0 = prompt.shape
    L = S0 + n_steps
    runs = {}
    for name, m, p in (("one", None, params),
                       ("mesh", mesh, distribute_params(params, mesh))):
        prefill = make_prefill_step(cfg, m, "decode_32k", batch=B, seq=L,
                                    device=torch.device("cpu"))
        tokens = torch.from_numpy(prompt)
        logits, cache = prefill(p, {"tokens": tokens})
        rows = [logits.full_tensor() if hasattr(logits, "full_tensor")
                else logits]
        tok = torch.argmax(rows[0], -1).to(torch.int32)[:, None]
        for i in range(n_steps):
            with on_mesh(cfg, m):
                lg, cache = models.decode_step(p, cfg, tok, cache, S0 + i)
                lg = lg.full_tensor() if hasattr(lg, "full_tensor") else lg
            rows.append(lg[:, -1])
            tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
        runs[name] = np.stack([r.detach().numpy() for r in rows])
        # the step builder's greedy token from the final cache
        dec = make_decode_step(cfg, m, "decode_32k", seq=L)
        runs[name + "_next"] = dec(p, tok, cache)[0].numpy()
    return _rank0(runs)


def reshard(arch, ckpt_dir, src_shape, dst_shape):
    """Save a sharded state (params + AdamW state after one step) on
    ``src_shape``, restore it onto ``dst_shape`` with
    ``restore(shardings=)``. Returns the state saved (full) and the
    state restored (full) and the restored placements."""
    from repro_torch.checkpoint import ckpt

    cfg = small_cfg(arch)
    src = make_host_mesh(*src_shape, device_type="cpu")
    step, opt = make_train_step(cfg, src, lr=1e-2)
    params = models.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    _, shard = train_state_specs(cfg, src, opt)
    state = distribute({"params": params, "opt": opt.init(params),
                              "step": torch.zeros((), dtype=torch.int32)},
                             src, shard)
    tok = np.random.default_rng(5).integers(0, cfg.vocab, (8, 16)).astype(
        np.int32)
    batch = distribute_batch({"tokens": torch.from_numpy(tok),
                              "labels": torch.from_numpy(np.roll(tok, -1, 1))},
                             src)
    state, _ = step(state, batch)
    saved = _full_np(state)
    ckpt.save(state, ckpt_dir, 1)
    # the destination mesh spans every rank: build it over the same group
    dst = make_host_mesh(*dst_shape, device_type="cpu")
    like, dshard = train_state_specs(cfg, dst, opt)
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), like)
    restored, at = ckpt.restore(like, ckpt_dir, shardings=dshard, mesh=dst)
    pl = [(k, tuple(v.placements)) for k, v in items(restored["params"])]
    return _rank0({"saved": saved, "restored": _full_np(restored),
                   "step": at, "placements": pl})


def gradcomp(g_pods, e_pods, n_pods):
    """``pod_quantized_allreduce`` on a (pod, 1, world / pod) mesh, or,
    where the pods do not divide the ranks, on a group of the first
    ``n_pods`` ranks: pod p's grads are ``g_pods[p]`` (plain tensors, the
    same on the pod's ranks). Returns every rank's codes, scale, output and new error
    state, and the bytes counted."""
    from repro_torch.quant.gradcomp import (_quantize_int8,
                                            pod_quantized_allreduce)

    world, res = dist.get_world_size(), None
    if world % n_pods == 0:
        mesh = make_host_mesh(1, world // n_pods, pod=n_pods,
                              device_type="cpu")
        p, group = mesh.get_local_rank("pod"), mesh.get_group("pod")
    else:            # one rank a pod, over the first n_pods ranks
        group = dist.new_group(list(range(n_pods)))
        p = dist.get_rank() if dist.get_rank() < n_pods else None
    if p is not None:
        g = {"w": torch.from_numpy(g_pods[p])}
        e = {"w": torch.from_numpy(e_pods[p])}
        q, s = _quantize_int8(g["w"] + e["w"])
        stats = {}
        out, err = pod_quantized_allreduce(g, e, group=group, stats=stats)
        res = {"codes": q.numpy(), "scale": float(s),
               "out": out["w"].numpy(), "err": err["w"].numpy(),
               "stats": stats}
    gathered = [None] * world
    dist.all_gather_object(gathered, res)
    return _rank0([r for r in gathered if r is not None])


def pod_step(arch, ref_params, batch, n_pods, model):
    """``wrap_pod_train_step`` on a (pod, 1, model) mesh around the
    sharded value-and-grad. Returns the exchanged grads and the error
    state (full, the reference's stacked layout), the metrics and the
    bytes counted."""
    from repro_torch.quant.gradcomp import (init_error_feedback,
                                            wrap_pod_train_step)

    cfg = small_cfg(arch)
    mesh = make_host_mesh(1, model, pod=n_pods, device_type="cpu")
    sub = mesh["data", "model"]
    params = distribute_params(
        models.params_from_reference(ref_params, cfg, "cpu"), sub)

    def core(state, rows):
        with on_mesh(cfg, sub):
            loss, metrics, grads = value_and_grad(
                state["params"], cfg, distribute_batch(rows, sub))
            grads = tree_map(placed_as, grads, state["params"])
            return grads, dict(metrics, loss=loss)

    stepped = wrap_pod_train_step(core, mesh)
    err = init_error_feedback(params)
    stats = {}
    grads, new_err, metrics = stepped(
        {"params": params}, err,
        {k: torch.from_numpy(v) for k, v in batch.items()}, stats)
    grads = _full_np(stack_layers(grads, cfg))
    new_err = _full_np(stack_layers(new_err, cfg))
    return _rank0({"grads": grads, "err": new_err, "stats": stats,
                   "metrics": {k: float(v) for k, v in metrics.items()}})


def pipeline(ws, x):
    """``pipeline_forward`` of ``tanh(h @ w)`` stages over every rank."""
    from repro_torch.runtime.pipeline import pipeline_forward

    stats = {}
    out = pipeline_forward(lambda w, h: torch.tanh(h @ w),
                           torch.from_numpy(ws), torch.from_numpy(x),
                           group=dist.group.WORLD,
                           n_stages=dist.get_world_size(), stats=stats)
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, (out.numpy(), stats))
    return _rank0(gathered)


def _collective_sweep() -> dict:
    """Each c10d collective once on the current group, its result held
    to the one it must give: {name: ok} (every rank's own)."""
    r, n = dist.get_rank(), dist.get_world_size()
    t = lambda v: torch.full((3,), float(v))          # noqa: E731
    ok = {}
    x = t(r + 1)
    dist.all_reduce(x)
    ok["all_reduce"] = torch.equal(x, t(n * (n + 1) / 2))
    x = t(r + 1)
    dist.broadcast(x, 0)
    ok["broadcast"] = torch.equal(x, t(1))
    xs = [t(0) for _ in range(n)]
    dist.all_gather(xs, t(r))
    ok["all_gather"] = all(torch.equal(v, t(i)) for i, v in enumerate(xs))
    x = torch.zeros(3 * n)
    dist.all_gather_into_tensor(x, t(r))
    ok["all_gather_into_tensor"] = torch.equal(
        x, torch.arange(n).float().repeat_interleave(3))
    x = t(0)
    dist.reduce_scatter_tensor(x, torch.arange(3 * n).float() + r)
    ok["reduce_scatter_tensor"] = torch.equal(
        x, n * (torch.arange(3).float() + 3 * r) + n * (n - 1) / 2)
    x = torch.zeros(n)
    dist.all_to_all_single(x, torch.arange(n).float() + 10 * r)
    ok["all_to_all_single"] = torch.equal(x, 10 * torch.arange(n).float()
                                          + r)
    x = t(r + 1)
    dist.reduce(x, 0)
    ok["reduce"] = r != 0 or torch.equal(x, t(n * (n + 1) / 2))
    xs = [t(0) for _ in range(n)] if r == 0 else None
    dist.gather(t(r), xs, 0)
    ok["gather"] = r != 0 or all(torch.equal(v, t(i))
                                 for i, v in enumerate(xs))
    x = t(-1)
    dist.scatter(x, [t(i) for i in range(n)] if r == 0 else None, 0)
    ok["scatter"] = torch.equal(x, t(r))
    x = t(-1)                           # a ring: every send before a recv
    for w in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t(r), (r + 1) % n),
            dist.P2POp(dist.irecv, x, (r - 1) % n)]):
        w.wait()
    ok["send_recv"] = torch.equal(x, t((r - 1) % n))
    dist.barrier()
    ok["barrier"] = True
    return ok


def staged(store, arch, shape, ref_params, batches, lr):
    """The group joined again through the ``gloo_host`` backend, staging
    the CPU tensors through copies as it stages CUDA tensors on a GPU:
    every collective once, then ``train_steps``. Returns the sweep, the
    bytes staged each way, and the steps' result."""
    from repro_torch.launch.host_gloo import bytes_staged, register

    rank, size = dist.get_rank(), dist.get_world_size()
    dist.destroy_process_group()
    dist.init_process_group(register(stage_cpu=True),
                            store=dist.FileStore(store, size), rank=rank,
                            world_size=size)
    sweep = _collective_sweep()
    before = bytes_staged()
    out = train_steps(arch, shape, ref_params, batches, lr)
    after = bytes_staged()
    sweeps = [None] * size
    dist.all_gather_object(sweeps, sweep)
    return _rank0(dict(out or {}, sweeps=sweeps, backend=dist.get_backend(),
                       staged=(after[0] - before[0], after[1] - before[1])))


def several(calls):
    """Run ``(name, fn, args)`` calls in order on every rank (one group,
    the cold DTensor dispatch paid once). Returns {name: rank 0's
    result} on rank 0."""
    out = {name: fn(*args) for name, fn, args in calls}
    return _rank0(out)
