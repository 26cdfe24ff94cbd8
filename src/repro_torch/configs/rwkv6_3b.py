"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960
vocab=65536, Finch's data-dependent decay (port of
``repro/configs/rwkv6_3b.py``). Sub-quadratic: an O(1) decode state."""
from .base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="lm",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
        d_ff=8960, vocab=65536,
        group=(LayerSpec(mixer="rwkv6", ffn="cmix"),),
        rwkv_head_dim=64, scan_chunk=64, subquadratic=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-reduced", family="lm",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=224, vocab=263,
        group=(LayerSpec(mixer="rwkv6", ffn="cmix"),),
        rwkv_head_dim=16, scan_chunk=8, subquadratic=True,
        param_dtype="float32", compute_dtype="float32",
    )
