"""Value-shared tensors (port of ``repro/core/types.py``).

A quantized tensor is ``codebook[indices].reshape(shape)``: the storage
format PTQ produces and quantized serving consumes undequantized.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class QuantizedTensor:
    """Value-shared tensor: ``dense = codebook[indices].reshape(shape)``.

    codebook: (L,) f32 distinct values (sorted ascending).
    indices:  flat integer codes, uint8 if L <= 256 else int32, of length
              prod(shape).
    shape:    the dense shape.
    dtype:    the dense dtype (a torch dtype).
    """

    codebook: torch.Tensor
    indices: torch.Tensor
    shape: tuple
    dtype: torch.dtype

    @property
    def stacked(self) -> bool:
        """Stacked form: a leading group axis on codebook (G, L) and
        indices (G, prod(shape)); ``shape`` describes one slice
        (``stack_quantized``)."""
        return self.indices.dim() == 2

    def to_dense(self) -> torch.Tensor:
        idx = self.indices.long()
        if self.stacked:
            dense = torch.take_along_dim(self.codebook, idx, dim=1)
            return dense.reshape((idx.shape[0],) + tuple(self.shape)).to(
                self.dtype)
        return self.codebook[idx].reshape(self.shape).to(self.dtype)

    def to(self, dtype: torch.dtype) -> "QuantizedTensor":
        """The same codes and codebook with another dense dtype (the dtype
        ``to_dense`` gives): the codes are never re-solved."""
        return dataclasses.replace(self, dtype=dtype)

    def float(self) -> "QuantizedTensor":
        return self.to(torch.float32)

    @property
    def num_values(self) -> int:
        return int(self.codebook.shape[-1])

    def bits_per_value(self) -> int:
        return math.ceil(math.log2(max(self.num_values, 2)))

    def nbytes(self) -> int:
        """Compressed footprint: the f32 codebook plus bit-packed codes."""
        n = math.prod(self.shape) * (
            self.indices.shape[0] if self.stacked else 1)
        return self.codebook.numel() * 4 + (n * self.bits_per_value()
                                            + 7) // 8


def _index_dtype(num_values: int) -> torch.dtype:
    return torch.uint8 if num_values <= 256 else torch.int32


def from_dense(w: torch.Tensor, reconstructed_unique: torch.Tensor,
               inverse_idx: torch.Tensor) -> QuantizedTensor:
    """A QuantizedTensor from a per-unique-value reconstruction.

    reconstructed_unique: (m,) the value assigned to each unique input value.
    inverse_idx: (n,) index into the unique array of each flat element.
    """
    codebook, code_of_unique = torch.unique(
        reconstructed_unique.to(torch.float64), sorted=True,
        return_inverse=True)
    indices = code_of_unique[inverse_idx.to(code_of_unique.device)]
    dtype = torch.float32 if w.dtype == torch.float64 else w.dtype
    return QuantizedTensor(
        codebook=codebook.to(torch.float32),
        indices=indices.to(_index_dtype(codebook.shape[0])),
        shape=tuple(w.shape), dtype=dtype)


def stack_quantized(qts: list[QuantizedTensor]) -> QuantizedTensor:
    """Stack per-slice QuantizedTensors of one shape into the stacked form:
    codebook (G, L) / indices (G, n). Shorter codebooks are right-padded
    with their last value (no code references the padding)."""
    if len({tuple(qt.shape) for qt in qts}) != 1:
        raise ValueError("stack_quantized: slices must share a shape")
    L = max(qt.num_values for qt in qts)
    cbs = [torch.cat([qt.codebook.float(), qt.codebook[-1:].float().expand(
        L - qt.num_values)]) for qt in qts]
    idx_dtype = _index_dtype(L)
    return QuantizedTensor(
        codebook=torch.stack(cbs),
        indices=torch.stack([qt.indices.to(idx_dtype) for qt in qts]),
        shape=tuple(qts[0].shape), dtype=qts[0].dtype)


def hard_sigmoid(x: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """Eq. 21 of the paper: clamp quantized outputs into [a, b]."""
    return torch.clamp(x, a, b)
