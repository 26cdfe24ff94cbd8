"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 - local (window 4096) + global alternating attention, logit
softcaps, post-block norms, GeGLU, scaled tied embedding (port of
``repro/configs/gemma2_27b.py``)."""
from .base import LayerSpec, ModelConfig

_GROUP = (LayerSpec(mixer="attn", ffn="dense", window=4096),   # local
          LayerSpec(mixer="attn", ffn="dense"))                # global


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b", family="lm",
        n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
        d_ff=36864, vocab=256000, group=_GROUP,
        attn_softcap=50.0, final_softcap=30.0, post_block_norm=True,
        act="gelu", tie_embeddings=True, embed_scale=True,
        rope_theta=10000.0,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma2-reduced", family="lm",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=211,
        group=(LayerSpec(mixer="attn", ffn="dense", window=8),
               LayerSpec(mixer="attn", ffn="dense")),
        attn_softcap=50.0, final_softcap=30.0, post_block_norm=True,
        act="gelu", tie_embeddings=True, embed_scale=True,
        param_dtype="float32", compute_dtype="float32", scan_chunk=8,
    )
