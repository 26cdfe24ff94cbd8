"""whisper-tiny [audio]: 4L enc + 4L dec, d_model=384 6H d_ff=1536
vocab=51865 - encoder-decoder with cross-attention (port of
``repro/configs/whisper_tiny.py``). The conv frontend is a stub: the
encoder takes precomputed frame embeddings (B, S_enc, 384); RoPE stands
in for whisper's learned absolute positions, as in the reference."""
from .base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="encdec",
        n_layers=4, n_enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
        head_dim=64, d_ff=1536, vocab=51865,
        group=(LayerSpec(mixer="attn", ffn="dense", cross_attn=True),),
        act="gelu", input_kind="embeds",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-reduced", family="encdec",
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=269,
        group=(LayerSpec(mixer="attn", ffn="dense", cross_attn=True),),
        act="gelu", input_kind="embeds",
        param_dtype="float32", compute_dtype="float32", scan_chunk=8,
    )
