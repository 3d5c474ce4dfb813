"""qwen1.5-4b [dense]: MHA (kv=heads) with QKV bias.
[hf:Qwen/Qwen1.5-0.5B family; hf]"""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        n_layers=40,
        d_model=2560,
        n_heads=20,
        n_kv_heads=20,
        d_ff=6912,
        vocab_size=151_936,
        norm="rmsnorm",
        mlp="swiglu",
        rope="default",
        rope_theta=5_000_000.0,
        qkv_bias=True,
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="qwen1.5-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=160, vocab_size=128, head_dim=0,
    )
