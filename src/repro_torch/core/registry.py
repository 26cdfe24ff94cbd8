"""Solver registry (port of ``repro/core/registry.py``): one entry per
quantization method the port can run.

  param_kind    "count" (budget-parameterised, ``method@L``) or "lam"
                (penalty-parameterised, ``method:lam=X``). ``QuantSpec``
                validates its parameters against it.
  host_solve    ``(ctx, spec, **kw) -> (recon, alpha_or_None)`` on the
                sorted-unique problem; ``core.api.quantize`` drives it.
  device_batch  the batched row solver ``(rows, spec) -> (codes, cb)`` that
                freezes KV pages, or None.
  accepts_lam2  the spec may carry ``lam2``.
  tree_batched  ``quant.ptq.quantize_tree(..., batched=True)`` can solve a
                whole parameter tree with it in one FISTA kernel launch.

The port has l1 and l1_ls (host CD; l1_ls also tree-batched), iter_l1
(host Algorithm 2; pages by batched FISTA), kmeans_ls and kmeans (host
solves; pages by the exact k-means DP, refit or not). Any other method
raises at spec construction, naming these.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable

import numpy as np
import torch

from .cd import cd_solve
from .iterative import iterative_l1
from .kmeans import kmeans_quantize_unique
from .kmeans_ls import kmeans_ls_quantize
from .problem import LSQProblem, reconstruct
from .refit import refit_support, support_of

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
    accepts_lam2: bool = False
    tree_batched: bool = False


def _cd(ctx: HostSolveContext, spec: "QuantSpec", **kw: Any):
    # the reference passes lambda as an f32 scalar
    alpha, sweeps = cd_solve(ctx.problem, float(np.float32(spec.lam)), **kw)
    ctx.info["sweeps"] = int(sweeps)
    return alpha


def _solve_l1(ctx: HostSolveContext, spec: "QuantSpec", **kw: Any):
    alpha = _cd(ctx, spec, **kw)
    return reconstruct(alpha, ctx.problem.d), alpha


def _solve_l1_ls(ctx: HostSolveContext, spec: "QuantSpec", **kw: Any):
    return refit_support(ctx.problem, support_of(_cd(ctx, spec, **kw)))


def _solve_iter_l1(ctx: HostSolveContext, spec: "QuantSpec", **kw: Any):
    recon, alpha, nnz, iters = iterative_l1(ctx.problem, ctx.num_values,
                                            **kw)
    ctx.info.update(nnz=nnz, iters=iters)
    return recon, alpha


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


def _pages(name: str) -> Callable:
    """A page solver of ``kernels.page_quant``, imported at first call so
    that importing ``core`` never imports kernel code."""
    def solve(rows, spec):
        from repro_torch.kernels import page_quant

        return getattr(page_quant, name)(rows, spec)
    solve.__name__ = name
    return solve


_REGISTRY: dict[str, Solver] = {s.name: s for s in (
    Solver("l1", "lam", _solve_l1,
           description="eq. 6 - raw l1 CD (no refit)"),
    Solver("l1_ls", "lam", _solve_l1_ls, tree_batched=True,
           description="alg. 1 - l1 CD + LS refit on the support "
                       "(tree-batched via the FISTA kernel)"),
    Solver("iter_l1", "count", _solve_iter_l1,
           _pages("quantize_pages_fista_spec"),
           "alg. 2 - lambda ramp to <= num_values (device backend: batched "
           "FISTA + per-row lambda bisection)"),
    Solver("kmeans_ls", "count", _solve_kmeans_ls,
           _pages("quantize_pages_kmeans_spec"),
           "alg. 3 - k-means support + LS values (device backend: exact "
           "1-D k-means DP on a quantile sketch, then an LS refit)"),
    Solver("kmeans", "count", _solve_kmeans,
           _pages("quantize_pages_kmeans_raw_spec"),
           "baseline §4 - plain 1-D k-means (device backend: the same DP, "
           "no refit)"),
)}


def get(name: str) -> Solver:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown quantization method {name!r}; registered "
                         f"methods: {', '.join(sorted(_REGISTRY))}") from None


def methods() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def lam_methods() -> tuple[str, ...]:
    return tuple(n for n, s in _REGISTRY.items() if s.param_kind == "lam")


def count_methods() -> tuple[str, ...]:
    return tuple(n for n, s in _REGISTRY.items() if s.param_kind == "count")


def device_methods() -> list[str]:
    """Methods with a batched device solver: the ones that freeze pages."""
    return sorted(n for n, s in _REGISTRY.items() if s.device_batch)
