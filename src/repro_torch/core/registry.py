"""Solver registry (port of ``repro/core/registry.py``): one entry per
quantization method, the reference's twelve, method for method.

  param_kind    "count" (budget-parameterised, ``method@L``) or "lam"
                (penalty-parameterised, ``method:lam=X``). ``QuantSpec``
                validates its parameters against it.
  host_solve    ``(ctx, spec, **kw) -> (recon, alpha_or_None)`` on the
                sorted-unique problem; ``core.api.quantize`` drives it.
  device_batch  the batched row solver ``(rows, spec) -> (codes, cb)`` that
                freezes KV pages: a callable, or a ``"module:function"``
                string that ``device_batch_solve`` imports at first use
                (so importing ``core`` never imports kernel code), or None.
  accepts_lam2  the spec may carry ``lam2``.
  tree_batched  ``quant.ptq.quantize_tree(..., batched=True)`` can solve a
                whole parameter tree with it in one FISTA kernel launch.

Host solves: CD for l1, l1_ls and l1l2 and Algorithm 2 (iter_l1), the
exact TV solver (tv, tv_iter), l0's hard-threshold CD and the DP (dp) run
over float64 host values and return tensors on the problem's device;
k-means (kmeans, kmeans_ls, and the seeds of mog and dtc) and mog's EM
run in torch on that device. Pages freeze by the batched device solvers
of iter_l1, kmeans_ls and kmeans; the other count methods freeze a page
at a time through their host solves
(``serving.kv_cache.quantize_page``), as in the reference.

Adding a solver is one ``register(Solver(...))`` call, as in the
reference: ``quantize``, ``QuantSpec`` validation, PTQ and the serving
engine's freeze (``--kv-quant name@L``) find it here. The capability
tuples of ``core.api`` (``ALL_METHODS`` ...) are snapshots taken at
import, in both packages; ``methods()`` and its kin read the registry as
it stands.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import TYPE_CHECKING, Any, Callable

import numpy as np
import torch

from .cd import cd_solve, max_stable_lam2
from .dp_optimal import optimal_kmeans_1d
from .dtc import dtc_quantize_unique
from .iterative import iterative_l1, tv_iterative
from .kmeans import kmeans_quantize_unique
from .kmeans_ls import kmeans_ls_quantize
from .l0 import l0_quantize
from .mog import mog_quantize_unique
from .problem import LSQProblem, reconstruct
from .refit import refit_support, support_of
from .tv_exact import tv_solve_problem, tv_support

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
    param_kind: str                     # "lam" | "count"
    host_solve: Callable[..., Any]
    device_batch: Callable | str | None = None
    accepts_lam2: bool = False
    tree_batched: bool = False
    description: str = ""

    def __post_init__(self) -> None:
        if self.param_kind not in ("lam", "count"):
            raise ValueError(f"param_kind must be 'lam' or 'count', got "
                             f"{self.param_kind!r}")


_REGISTRY: dict[str, Solver] = {}
_DEVICE_CACHE: dict[str, Callable] = {}


def register(solver: Solver) -> Solver:
    """Add ``solver`` to the registry, or replace the entry of its name
    (and forget the device solver resolved for the old one)."""
    _REGISTRY[solver.name] = solver
    _DEVICE_CACHE.pop(solver.name, None)
    return solver


def _f32(x: float) -> float:
    """A scalar rounded to f32, as the reference passes lambdas."""
    return float(np.float32(x))


def _cd(ctx: HostSolveContext, spec: "QuantSpec", lam2: float = 0.0,
        **kw: Any):
    alpha, sweeps = cd_solve(ctx.problem, _f32(spec.lam), _f32(lam2), **kw)
    ctx.info["sweeps"] = int(sweeps)
    return alpha


def _solve_l1(ctx: HostSolveContext, spec: "QuantSpec", **kw: Any):
    alpha = _cd(ctx, spec, **kw)
    # the host's sequential cumsum: a run of zero alpha adds exact zeros,
    # so it keeps one value; the card's parallel scan may round equal
    # prefixes apart and split a shared value
    d = ctx.problem.d
    return reconstruct(alpha.cpu(), d.cpu()).to(d.device), alpha


def _solve_l1_ls(ctx: HostSolveContext, spec: "QuantSpec", **kw: Any):
    return refit_support(ctx.problem, support_of(_cd(ctx, spec, **kw)))


def _solve_l1l2(ctx: HostSolveContext, spec: "QuantSpec", **kw: Any):
    stable = max_stable_lam2(ctx.problem)
    # the default, and a clamp that keeps eq. 13 convex
    lam2 = 0.25 * stable if spec.lam2 is None else min(spec.lam2,
                                                       0.49 * stable)
    alpha = _cd(ctx, spec, lam2, **kw)
    ctx.info["lam2"] = float(lam2)
    return refit_support(ctx.problem, support_of(alpha))


def _solve_tv(ctx: HostSolveContext, spec: "QuantSpec", **kw: Any):
    u = tv_solve_problem(ctx.problem, float(spec.lam), **kw)
    return refit_support(ctx.problem, tv_support(u))


def _solve_l0(ctx: HostSolveContext, spec: "QuantSpec", **kw: Any):
    alpha, nnz = l0_quantize(ctx.problem, ctx.num_values, **kw)
    ctx.info["nnz"] = nnz
    return refit_support(ctx.problem, support_of(alpha))


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


def _solve_tv_iter(ctx: HostSolveContext, spec: "QuantSpec", **kw: Any):
    recon, alpha, nnz, iters = tv_iterative(ctx.problem, ctx.num_values,
                                            **kw)
    ctx.info.update(nnz=nnz, iters=iters)
    return recon, alpha


def _solve_mog(ctx: HostSolveContext, spec: "QuantSpec", **kw: Any):
    recon, _, _ = mog_quantize_unique(ctx.problem.w_hat, ctx.problem.counts,
                                      ctx.num_values, seed=spec.seed, **kw)
    return recon, None


def _solve_dtc(ctx: HostSolveContext, spec: "QuantSpec", **kw: Any):
    recon, _, _ = dtc_quantize_unique(ctx.problem.w_hat, ctx.problem.counts,
                                      ctx.num_values, seed=spec.seed, **kw)
    return recon, None


def _solve_dp(ctx: HostSolveContext, spec: "QuantSpec", **kw: Any):
    counts = ctx.counts if spec.weighted else torch.ones_like(ctx.counts)
    recon, _, _, sse = optimal_kmeans_1d(ctx.vals, counts, ctx.num_values,
                                         **kw)
    ctx.info["sse_unique"] = sse
    return recon, None


_PAGES = "repro_torch.kernels.page_quant:"

register(Solver("l1", "lam", _solve_l1,
                description="eq. 6 - raw l1 CD (no refit)"))
register(Solver("l1_ls", "lam", _solve_l1_ls, tree_batched=True,
                description="alg. 1 - l1 CD + LS refit on the support "
                            "(tree-batched via the FISTA kernel)"))
register(Solver("l1l2", "lam", _solve_l1l2, accepts_lam2=True,
                description="eq. 13 - l1 + negative-l2 CD (+ refit)"))
register(Solver("tv", "lam", _solve_tv,
                description="beyond-paper exact O(m) global optimum of "
                            "eq. 6"))
register(Solver("l0", "count", _solve_l0,
                description="eq. 16 - l0-constrained CD w/ gamma "
                            "bisection"))
register(Solver("iter_l1", "count", _solve_iter_l1,
                device_batch=_PAGES + "quantize_pages_fista_spec",
                description="alg. 2 - lambda ramp to <= num_values (device "
                            "backend: batched FISTA + per-row lambda "
                            "bisection)"))
register(Solver("tv_iter", "count", _solve_tv_iter,
                description="exact-count via lambda bisection on tv"))
register(Solver("kmeans_ls", "count", _solve_kmeans_ls,
                device_batch=_PAGES + "quantize_pages_kmeans_spec",
                description="alg. 3 - k-means support + LS values (device "
                            "backend: exact 1-D k-means DP on a quantile "
                            "sketch, then an LS refit)"))
register(Solver("kmeans", "count", _solve_kmeans,
                device_batch=_PAGES + "quantize_pages_kmeans_raw_spec",
                description="baseline §4 - plain 1-D k-means (device "
                            "backend: the same DP, no refit)"))
register(Solver("mog", "count", _solve_mog,
                description="baseline §4 - mixture-of-Gaussians EM"))
register(Solver("dtc", "count", _solve_dtc,
                description="baseline §4 - decision-tree clustering"))
register(Solver("dp", "count", _solve_dp,
                description="optimal 1-D quantizer (loss lower bound)"))


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


def device_methods() -> tuple[str, ...]:
    """Methods with a batched device solver (the ones that freeze pages
    on the device), in registration order."""
    return tuple(n for n, s in _REGISTRY.items() if s.device_batch)


def device_batch_solve(name: str) -> Callable:
    """A method's device row solver ``(rows, spec) -> (codes, cb)``; a
    ``"module:function"`` entry is imported at first use and cached."""
    solver = get(name)
    if not solver.device_batch:
        raise ValueError(
            f"method {name!r} has no batched device solver; device-capable "
            f"methods: {', '.join(device_methods())}")
    fn = _DEVICE_CACHE.get(name)
    if fn is None:
        fn = solver.device_batch
        if isinstance(fn, str):
            mod, _, attr = fn.partition(":")
            fn = getattr(importlib.import_module(mod), attr)
        _DEVICE_CACHE[name] = fn
    return fn
