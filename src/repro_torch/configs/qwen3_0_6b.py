"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936 - qk_norm, GQA (port of ``repro/configs/qwen3_0_6b.py``)."""
from .base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", family="lm",
        n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=3072, vocab=151936, group=(LayerSpec(),),
        qk_norm=True, rope_theta=1_000_000.0, tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-reduced", family="lm",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=128, vocab=499, group=(LayerSpec(),),
        qk_norm=True, rope_theta=1_000_000.0, tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32",
    )
