"""whisper-large-v3 [audio]: encoder-decoder, conv frontend STUB
(input_specs provides 1500 precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="encdec",
        n_layers=32,  # decoder layers
        enc_layers=32,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab_size=51_866,
        norm="layernorm",
        mlp="gelu",
        rope="none",  # absolute positions (sinusoidal enc / learned dec)
        qkv_bias=True,
        attn_out_bias=True,
        mlp_bias=True,
        enc_positions=1500,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="whisper-smoke",
        n_layers=2,
        enc_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=128,
        enc_positions=16,
        head_dim=0,
    )
