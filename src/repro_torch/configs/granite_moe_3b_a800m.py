"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8, tied head (port of
``repro/configs/granite_moe_3b_a800m.py``)."""
from .base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="lm",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
        d_ff=512, vocab=49155,
        group=(LayerSpec(mixer="attn", ffn="moe"),),
        n_experts=40, top_k=8, expert_ff=512,
        tie_embeddings=True, rope_theta=10000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-reduced", family="lm",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=48, vocab=293,
        group=(LayerSpec(mixer="attn", ffn="moe"),),
        n_experts=10, top_k=4, expert_ff=48,
        tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32", scan_chunk=8,
    )
