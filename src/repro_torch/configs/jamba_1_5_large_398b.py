"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16 experts top-2, Mamba and attention
interleaved 7:1 (port of ``repro/configs/jamba_1_5_large_398b.py``).

Pattern: 8-layer groups, attention at in-group index 4, MoE on every odd
layer. Full depth (~398 B params) does not fit one card: ``--layers N``
keeps the first N layers, cutting inside a group
(``launch/serve.py:cut_depth``)."""
from .base import LayerSpec, ModelConfig


def _group():
    return tuple(LayerSpec(mixer="attn" if i == 4 else "mamba",
                           ffn="moe" if i % 2 == 1 else "dense")
                 for i in range(8))


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="lm",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=24576, vocab=65536, group=_group(),
        n_experts=16, top_k=2, expert_ff=24576,
        ssm_d_state=16, ssm_d_conv=4, ssm_expand=2,
        scan_chunk=128, subquadratic=True,
        optimizer="adafactor", opt_state_dtype="bfloat16",
    )


def reduced() -> ModelConfig:
    g = tuple(LayerSpec(mixer="attn" if i == 2 else "mamba",
                        ffn="moe" if i % 2 == 1 else "dense")
              for i in range(4))
    return ModelConfig(
        name="jamba-reduced", family="lm",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=281, group=g,
        n_experts=4, top_k=2, expert_ff=128,
        ssm_d_state=4, ssm_d_conv=4, ssm_expand=2, scan_chunk=8,
        subquadratic=True,
        param_dtype="float32", compute_dtype="float32",
    )
