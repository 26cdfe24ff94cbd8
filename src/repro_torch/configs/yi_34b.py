"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
- llama-arch GQA (7 query heads a kv head), untied head (port of
``repro/configs/yi_34b.py``)."""
from .base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", family="lm",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
        d_ff=20480, vocab=64000, group=(LayerSpec(),),
        rope_theta=5_000_000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="yi-reduced", family="lm",
        n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=160, vocab=257, group=(LayerSpec(),),
        rope_theta=5_000_000.0,
        param_dtype="float32", compute_dtype="float32", scan_chunk=8,
    )
