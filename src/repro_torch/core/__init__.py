"""Quantizers of the port (port of ``repro/core``, the kmeans_ls path):
the sorted-unique LSQ problem, the LS refit, 1-D k-means, Algorithm 3,
value-shared tensors, the spec and its registry, and ``quantize``."""
from . import registry
from .api import quantize
from .kmeans import kmeans_1d
from .kmeans_ls import kmeans_ls_quantize
from .problem import (LSQProblem, make_problem, objective, reconstruct,
                      unique_with_counts)
from .refit import effective_num_values, refit_support, support_of
from .registry import device_methods
from .spec import QuantSpec, as_spec
from .types import QuantizedTensor, from_dense, hard_sigmoid, stack_quantized

__all__ = [
    "LSQProblem", "QuantSpec", "QuantizedTensor", "as_spec",
    "device_methods", "effective_num_values", "from_dense", "hard_sigmoid",
    "kmeans_1d", "kmeans_ls_quantize", "make_problem", "objective",
    "quantize", "reconstruct", "refit_support", "registry",
    "stack_quantized", "support_of", "unique_with_counts",
]
