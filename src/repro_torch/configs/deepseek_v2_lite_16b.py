"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff(expert)=1408
vocab=102400, MLA kv_lora=512, MoE 64 routed top-6 + 2 shared (port of
``repro/configs/deepseek_v2_lite_16b.py``). Layer 0 is MLA with a dense
FFN (d_ff=10944, a head layer); layers 1-26 are MLA + MoE."""
from .base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="lm",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=192,
        d_ff=10944, vocab=102400,
        head_layers=(LayerSpec(mixer="mla", ffn="dense"),),
        group=(LayerSpec(mixer="mla", ffn="moe"),),
        kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        n_experts=64, n_shared_experts=2, top_k=6, expert_ff=1408,
        rope_theta=10000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-reduced", family="lm",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=24,
        d_ff=160, vocab=401,
        head_layers=(LayerSpec(mixer="mla", ffn="dense"),),
        group=(LayerSpec(mixer="mla", ffn="moe"),),
        kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        n_experts=8, n_shared_experts=2, top_k=3, expert_ff=32,
        param_dtype="float32", compute_dtype="float32", scan_chunk=8,
    )
