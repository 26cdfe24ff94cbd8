"""Model configuration (port of ``repro/configs/base.py``).

A copy rather than an import: the reference module imports ``jax.numpy``
for dtypes. ``ModelConfig.dtype`` returns torch dtypes here. The
training fields (``optimizer``, ``opt_state_dtype``, ``remat``) carry the
reference's defaults and the configs' settings of them; ``quant_skip``,
which no module of either package reads, is left out.
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

    mixer: str = "attn"          # "attn" | "mla" | "mamba" | "rwkv6"
    ffn: str = "dense"           # "dense" | "moe" | "cmix" | "none"
    window: int | None = None    # local attention window
    cross_attn: bool = False     # decoder cross-attention (whisper)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # "lm" | "encdec"
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
    mrope_sections: Sequence[int] | None = None   # qwen2-vl M-RoPE
    post_block_norm: bool = False  # gemma2: norms on the mixer and FFN outputs
    attn_q_chunk: int = 512
    kv_cache_dtype: str = "compute"   # "compute" | "int8" (quantized ring)
    # MLA (deepseek)
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 2
    expert_ff: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # SSM / RWKV
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0          # 0 -> d_model/16
    rwkv_head_dim: int = 64
    scan_chunk: int = 128         # sequence chunking for SSM/RWKV scans
    # enc-dec
    n_enc_layers: int = 0
    enc_bidirectional: bool = True
    input_kind: str = "tokens"    # "tokens" | "embeds" (stub frontends)
    tie_embeddings: bool = False
    embed_scale: bool = False
    act: str = "silu"             # "silu" (swiglu) | "gelu" (geglu)
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"      # "adamw" | "adafactor"
    opt_state_dtype: str = "float32"
    remat: str = "full"           # "none" | "full" | "dots"
    # sub-quadratic in context (O(1) decode state): the SSM archs
    subquadratic: bool = False
    notes: str = ""

    @property
    def n_groups(self) -> int:
        return (self.n_layers - len(self.head_layers)) // len(self.group)

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or max(self.d_model // 16, 8)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

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
        if self.family == "encdec" and self.n_enc_layers <= 0:
            raise ValueError(f"{self.name}: an encdec config needs "
                             f"n_enc_layers > 0")
        return self


ARCHS = ["qwen3_0_6b", "glm4_9b", "yi_34b", "gemma2_27b",
         "deepseek_v2_lite_16b", "granite_moe_3b_a800m", "qwen2_vl_72b",
         "whisper_tiny", "rwkv6_3b", "jamba_1_5_large_398b"]


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
