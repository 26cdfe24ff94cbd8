"""Quantizers of the port (port of ``repro/core``): the sorted-unique LSQ
problem, coordinate descent (Algorithm 1, eq. 13), the lambda ramp
(Algorithm 2), the LS refit, 1-D k-means, Algorithm 3, l0 (eq. 16), the
exact TV solver, the optimal 1-D DP, the mog and dtc baselines,
value-shared tensors, the spec and its registry, and ``quantize``."""
from . import registry
from .api import ALL_METHODS, COUNT_METHODS, LAM_METHODS, quantize
from .cd import cd_solve, cd_solve_dense_reference, cd_sweep, max_stable_lam2
from .dp_optimal import optimal_kmeans_1d
from .iterative import iterative_l1, tv_iterative
from .kmeans import kmeans_1d, kmeans_quantize_unique
from .kmeans_ls import kmeans_ls_dense_reference, kmeans_ls_quantize
from .l0 import l0_quantize, l0_solve
from .mog import mog_quantize_unique
from .problem import (LSQProblem, make_problem, objective, reconstruct,
                      unique_with_counts)
from .refit import (effective_num_values, refit_support,
                    refit_support_dense_reference, support_of)
from .registry import device_methods
from .spec import QuantSpec, as_spec
from .tv_exact import tv1d_weighted, tv_solve_problem
from .types import QuantizedTensor, from_dense, hard_sigmoid, stack_quantized

__all__ = [
    "ALL_METHODS", "COUNT_METHODS", "LAM_METHODS", "LSQProblem",
    "QuantSpec", "QuantizedTensor", "as_spec", "cd_solve",
    "cd_solve_dense_reference", "cd_sweep", "device_methods",
    "effective_num_values", "from_dense", "hard_sigmoid", "iterative_l1",
    "kmeans_1d", "kmeans_ls_dense_reference", "kmeans_ls_quantize",
    "kmeans_quantize_unique",
    "l0_quantize", "l0_solve", "make_problem", "max_stable_lam2",
    "mog_quantize_unique", "objective", "optimal_kmeans_1d", "quantize",
    "reconstruct", "refit_support", "refit_support_dense_reference",
    "registry", "stack_quantized",
    "support_of", "tv1d_weighted", "tv_iterative", "tv_solve_problem",
    "unique_with_counts",
]
