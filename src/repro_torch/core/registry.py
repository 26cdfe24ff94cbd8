"""Solver registry (port of ``repro/core/registry.py``): one entry per
quantization method the port can run.

  param_kind    "count" (budget-parameterised, ``method@L``) or "lam".
                ``QuantSpec`` validates its parameters against it.
  host_solve    ``(ctx, spec, **kw) -> (recon, alpha_or_None)`` on the
                sorted-unique problem; ``core.api.quantize`` drives it.
  device_batch  the batched row solver ``(rows, spec) -> (codes, cb)`` that
                freezes KV pages, or None.

The port has kmeans_ls (host solve and page freezing) and kmeans (host
solve). Any other method raises at spec construction, naming these.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable

import torch

from .kmeans import kmeans_quantize_unique
from .kmeans_ls import kmeans_ls_quantize
from .problem import LSQProblem

if TYPE_CHECKING:
    from .spec import QuantSpec


@dataclasses.dataclass
class HostSolveContext:
    """What a host solver sees: the sorted-unique problem, the unique
    values and counts in float64, the count budget clamped to ``m``, and
    ``info``, the quantize() report solvers add diagnostics to."""

    problem: LSQProblem
    vals: torch.Tensor
    counts: torch.Tensor
    num_values: int | None
    info: dict


@dataclasses.dataclass(frozen=True)
class Solver:
    """One method's parameterisation and backends."""

    name: str
    param_kind: str
    host_solve: Callable[..., Any]
    device_batch: Callable | None = None
    description: str = ""


def _solve_kmeans_ls(ctx: HostSolveContext, spec: "QuantSpec", **kw: Any):
    recon, alpha, _, iters = kmeans_ls_quantize(ctx.problem, ctx.num_values,
                                                seed=spec.seed, **kw)
    ctx.info["lloyd_iters"] = int(iters)
    return recon, alpha


def _solve_kmeans(ctx: HostSolveContext, spec: "QuantSpec", **kw: Any):
    recon, _, _, inertia, iters = kmeans_quantize_unique(
        ctx.problem.w_hat, ctx.problem.counts, ctx.num_values,
        seed=spec.seed, **kw)
    ctx.info.update(inertia=float(inertia), lloyd_iters=int(iters))
    return recon, None


def _kmeans_ls_pages(rows, spec):
    from repro_torch.kernels.page_quant import quantize_pages_kmeans_spec

    return quantize_pages_kmeans_spec(rows, spec)


_REGISTRY: dict[str, Solver] = {s.name: s for s in (
    Solver("kmeans_ls", "count", _solve_kmeans_ls, _kmeans_ls_pages,
           "alg. 3 - k-means support + LS values (device backend: exact "
           "1-D k-means DP on a quantile sketch, then an LS refit)"),
    Solver("kmeans", "count", _solve_kmeans,
           description="baseline §4 - plain 1-D k-means"),
)}


def get(name: str) -> Solver:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown quantization method {name!r}; registered "
                         f"methods: {', '.join(sorted(_REGISTRY))}") from None


def methods() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def device_methods() -> list[str]:
    """Methods with a batched device solver: the ones that freeze pages."""
    return sorted(n for n, s in _REGISTRY.items() if s.device_batch)
