"""Quantizers of the port (port of ``repro/core``): the sorted-unique LSQ
problem, coordinate descent (Algorithm 1) and the lambda ramp
(Algorithm 2), the LS refit, 1-D k-means, Algorithm 3, value-shared
tensors, the spec and its registry, and ``quantize``."""
from . import registry
from .api import quantize
from .cd import cd_solve, cd_solve_dense_reference, max_stable_lam2
from .iterative import iterative_l1
from .kmeans import kmeans_1d
from .kmeans_ls import kmeans_ls_quantize
from .problem import (LSQProblem, make_problem, objective, reconstruct,
                      unique_with_counts)
from .refit import effective_num_values, refit_support, support_of
from .registry import device_methods
from .spec import QuantSpec, as_spec
from .types import QuantizedTensor, from_dense, hard_sigmoid, stack_quantized

__all__ = [
    "LSQProblem", "QuantSpec", "QuantizedTensor", "as_spec", "cd_solve",
    "cd_solve_dense_reference", "device_methods", "effective_num_values",
    "from_dense", "hard_sigmoid", "iterative_l1", "kmeans_1d",
    "kmeans_ls_quantize", "make_problem", "max_stable_lam2", "objective",
    "quantize", "reconstruct", "refit_support", "registry",
    "stack_quantized", "support_of", "unique_with_counts",
]
