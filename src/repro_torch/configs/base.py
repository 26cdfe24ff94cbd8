"""Model configuration (port of ``repro/configs/base.py``).

A copy rather than an import: the reference module imports ``jax.numpy``
for dtypes. ``ModelConfig.dtype`` returns torch dtypes here.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Sequence

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer: a sequence mixer plus a feed-forward block."""

    mixer: str = "attn"          # "attn" (other mixers come in later slices)
    ffn: str = "dense"           # "dense" | "none"
    window: int | None = None    # local attention window
    cross_attn: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # "lm"
    n_layers: int = 12
    d_model: int = 1024
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 128
    d_ff: int = 4096
    vocab: int = 32000
    # layer pattern: `group` repeated n_layers/len(group) times after the
    # unrepeated `head_layers` (the reference scans the groups; the port
    # loops over layers)
    group: Sequence[LayerSpec] = (LayerSpec(),)
    head_layers: Sequence[LayerSpec] = ()
    rope_theta: float = 10000.0
    qk_norm: bool = False
    attn_softcap: float | None = None
    final_softcap: float | None = None
    post_block_norm: bool = False  # gemma2: norms on the mixer and FFN outputs
    attn_q_chunk: int = 512
    input_kind: str = "tokens"
    tie_embeddings: bool = False
    embed_scale: bool = False
    act: str = "silu"             # "silu" (swiglu) | "gelu" (geglu)
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    notes: str = ""

    @property
    def n_groups(self) -> int:
        return (self.n_layers - len(self.head_layers)) // len(self.group)

    def layer_specs(self) -> list[LayerSpec]:
        """Every layer in execution order (head layers, then the groups
        unrolled) — the port's Python loop over what the reference scans."""
        return list(self.head_layers) + list(self.group) * self.n_groups

    def dtype(self, kind: str) -> torch.dtype:
        return _DTYPES[getattr(self, kind + "_dtype")]

    def validate(self) -> "ModelConfig":
        if (self.n_layers - len(self.head_layers)) % len(self.group):
            raise ValueError(f"{self.name}: {self.n_layers} layers do not "
                             f"tile groups of {len(self.group)}")
        return self


ARCHS = ["qwen3_0_6b", "glm4_9b", "yi_34b", "gemma2_27b"]


def _module(arch: str):
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; the port has: "
                         f"{', '.join(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config().validate()


def get_reduced_config(arch: str) -> ModelConfig:
    return _module(arch).reduced().validate()


def list_archs() -> list[str]:
    return list(ARCHS)
