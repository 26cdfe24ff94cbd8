"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 - M-RoPE over (t, h, w) position streams, an int8 ring KV
cache (port of ``repro/configs/qwen2_vl_72b.py``). Backbone only: the
vision frontend is a stub, so the model takes precomputed embeddings
(B, S, d_model) and (3, B, S) positions (``input_kind="embeds"``)."""
from .base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", family="lm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=29568, vocab=152064, group=(LayerSpec(),),
        mrope_sections=(16, 24, 24), rope_theta=1_000_000.0,
        input_kind="embeds", optimizer="adafactor", opt_state_dtype="bfloat16",
        kv_cache_dtype="int8",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2vl-reduced", family="lm",
        n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
        d_ff=192, vocab=311, group=(LayerSpec(),),
        mrope_sections=(2, 3, 3), rope_theta=1_000_000.0,
        input_kind="embeds",
        param_dtype="float32", compute_dtype="float32", scan_chunk=8,
    )
