"""Three-term roofline of one H100 SXM (port of
``repro/analysis/roofline.py``).

  compute    = bf16 FLOPs / bf16 peak + f32 FLOPs / f32 peak   per device
  memory     = HBM bytes / HBM bandwidth                        per device
  collective = collective bytes / link rate                     per device

All inputs are per device, as ``analysis.hlo`` counts them. The dominant
term is the bottleneck, and the bound is the largest term (perfect
overlap). The rates are fields whose defaults are the H100's, read from
``repro_torch.device`` (defined there once), so a caller can price the
same counts at another device's rates:

- compute prices bf16 and f32 FLOPs each at its own rate: the port runs
  with TF32 off, so an f32 GEMM runs outside the tensor cores at 67
  TFLOP/s, against 989 TFLOP/s for bf16. ``flops`` is the total,
  ``flops_f32`` the part of it with f32 operands.
- the collective term divides the bytes a device sends by NVLink 4's
  rate one way (450 GB/s of its 900 GB/s both ways). A 16-wide mesh axis
  spans two 8-GPU NVLink domains, whose traffic between them crosses the
  slower network, so on the production meshes this term is a lower
  bound.

``model_params_active`` and ``model_flops`` are the reference's analytic
counts, arithmetic for arithmetic, over the port's configs.
"""
from __future__ import annotations

import dataclasses

from repro_torch.device import (BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S,
                                LINK_BYTES_PER_S)


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    model_flops_per_device: float = 0.0
    flops_f32: float = 0.0
    peak_bf16: float = BF16_FLOPS
    peak_f32: float = F32_FLOPS
    hbm_bw: float = HBM_BYTES_PER_S
    link_bw: float = LINK_BYTES_PER_S

    @property
    def t_compute(self) -> float:
        return ((self.flops - self.flops_f32) / self.peak_bf16
                + self.flops_f32 / self.peak_f32)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / self.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        """No-overlap pessimum is the sum; perfect overlap is the max. We
        report the max (roofline = best achievable)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Share of the bound in which the FLOPs run: how close the cell
        is to the compute roofline if perfectly overlapped."""
        t = self.step_time_lower_bound
        return 0.0 if t == 0 else self.t_compute / t

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: catches remat/redundant compute."""
        return (self.model_flops_per_device / self.flops) if self.flops else 0.0

    def as_dict(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "roofline_fraction": self.roofline_fraction,
            "useful_flops_ratio": self.useful_flops_ratio,
            "flops_per_device": self.flops,
            "flops_f32_per_device": self.flops_f32,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.collective_bytes,
            "model_flops_per_device": self.model_flops_per_device,
        }


# --------------------------------------------------- analytic model FLOPs


def model_params_active(cfg) -> tuple[int, int]:
    """(total params, active params per token) - MoE-aware, analytic."""
    D, V = cfg.d_model, cfg.vocab
    emb = V * D * (1 if cfg.tie_embeddings else 2)
    total = emb
    active = emb

    def attn_p():
        qo = D * cfg.n_heads * cfg.head_dim * 2
        kv = D * cfg.n_kv_heads * cfg.head_dim * 2
        return qo + kv

    def mla_p():
        return (D * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
                + D * cfg.kv_lora_rank + D * cfg.qk_rope_dim
                + cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
                + cfg.n_heads * cfg.v_head_dim * D)

    def mamba_p():
        E, N, R = cfg.d_inner, cfg.ssm_d_state, cfg.dt_rank
        return D * 2 * E + E * (2 * N + R) + R * E + E * N + E * D

    def rwkv_p():
        return 6 * D * D + D * cfg.d_ff * 2 + D * 64 * 2

    def specs():
        out = list(cfg.head_layers)
        out += list(cfg.group) * cfg.n_groups
        if cfg.family == "encdec":
            out += [dataclasses.replace(s, cross_attn=False)
                    for s in [cfg.group[0]] * cfg.n_enc_layers]
        return out

    for spec in specs():
        if spec.mixer == "attn":
            p = attn_p() * (2 if spec.cross_attn else 1)
        elif spec.mixer == "mla":
            p = mla_p()
        elif spec.mixer == "mamba":
            p = mamba_p()
        elif spec.mixer == "rwkv6":
            p = rwkv_p()
        total += p
        active += p
        if spec.ffn == "dense":
            f = 3 * D * cfg.d_ff
            total += f
            active += f
        elif spec.ffn == "moe":
            per_e = 3 * D * cfg.expert_ff
            total += per_e * cfg.n_experts
            active += per_e * cfg.top_k
            if cfg.n_shared_experts:
                sh = 3 * D * cfg.expert_ff * cfg.n_shared_experts
                total += sh
                active += sh
        elif spec.ffn == "cmix":
            pass  # counted in rwkv_p
    return int(total), int(active)


def model_flops(cfg, shape_kind: str, batch: int, seq: int) -> float:
    """6*N_active*D tokens for training; 2*N_active per token for inference."""
    _, active = model_params_active(cfg)
    tokens = batch * (seq if shape_kind in ("train", "prefill") else 1)
    per_token = (6 if shape_kind == "train" else 2) * active
    return float(per_token) * tokens
