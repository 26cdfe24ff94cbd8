"""Public quantization API (port of ``repro/core/api.py:quantize``): a
thin driver over the solver registry::

    from repro_torch.core import quantize

    qt, info = quantize(w, "kmeans_ls@16")
    qt, info = quantize(w, "l1_ls:lam=0.02")   # a lam method
    w_approx = qt.to_dense()

Methods (``core.registry`` holds them and their capabilities):

  paper         l1 (eq. 6), l1_ls (alg. 1), l1l2 (eq. 13), l0 (eq. 16),
                iter_l1 (alg. 2), kmeans_ls (alg. 3)
  baselines     kmeans, mog, dtc (paper §4)
  beyond paper  tv (the exact O(m) optimum of eq. 6), tv_iter (exact
                count by lambda bisection on tv), dp (the optimal 1-D
                quantizer, the loss lower bound)

It builds the sorted-unique problem on ``w``'s device, runs the method's
host solver, applies the spec's clip (eq. 21) and returns the
QuantizedTensor with the reference's ``info`` keys (``alpha`` too, for
methods that solve for it). The reference's
deprecated loose-kwargs form (``quantize(w, method=..., num_values=...)``)
is not ported: pass a QuantSpec or its string.
"""
from __future__ import annotations

import time
from typing import Any

import torch

from . import registry, types
from .problem import make_problem, unique_with_counts
from .spec import QuantSpec

# the capability tuples, derived from the registry
LAM_METHODS = registry.lam_methods()
COUNT_METHODS = registry.count_methods()
ALL_METHODS = registry.methods()


def quantize(w: torch.Tensor, spec: QuantSpec | str,
             **kw: Any) -> tuple[types.QuantizedTensor, dict]:
    """Quantize a tensor into a value-shared QuantizedTensor on its device.
    Extra ``**kw`` pass through to the method's host solver."""
    spec = QuantSpec.parse(spec)
    t0 = time.perf_counter()
    solver = registry.get(spec.method)
    vals, counts, inverse = unique_with_counts(w)
    problem = make_problem(vals, counts, weighted=spec.weighted)
    m = problem.m
    info: dict[str, Any] = {"m_unique": m, "method": spec.method,
                            "spec": str(spec)}
    budget = (None if spec.num_values is None
              else int(min(spec.num_values, m)))
    ctx = registry.HostSolveContext(problem=problem, vals=vals, counts=counts,
                                    num_values=budget, info=info)
    recon, alpha = solver.host_solve(ctx, spec, **kw)

    recon = recon.to(torch.float64)
    if spec.clip is not None:
        recon = recon.clamp(spec.clip[0], spec.clip[1])      # eq. 21
    qt = types.from_dense(w, recon, inverse)
    full = qt.to_dense().reshape(-1).double()
    flat = w.reshape(-1).double()
    info.update(
        n_values=qt.num_values,
        l2_loss=float(torch.sum((flat - full) ** 2)),
        l2_loss_unique=float(torch.sum((vals - recon) ** 2)),
        time_s=time.perf_counter() - t0,
        compressed_bytes=qt.nbytes(),
    )
    if alpha is not None:
        info["alpha"] = alpha
    return qt, info
