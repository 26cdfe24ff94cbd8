"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552
- RoPE, extreme GQA (2 KV heads), untied head (port of
``repro/configs/glm4_9b.py``)."""
from .base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", family="lm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
        d_ff=13696, vocab=151552, group=(LayerSpec(),),
        rope_theta=10000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="glm4-reduced", family="lm",
        n_layers=4, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=160, vocab=307, group=(LayerSpec(),),
        param_dtype="float32", compute_dtype="float32", scan_chunk=8,
    )
