"""minitron-8b [dense]: pruned nemotron — layernorm, squared-ReLU MLP,
partial rotary, 256k vocab. [arXiv:2407.14679; hf]"""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=16_384,
        vocab_size=256_000,
        norm="layernorm",
        mlp="relu2",  # nemotron squared relu
        rope="half",  # partial rotary (50%)
        rope_theta=10_000.0,
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="minitron-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=192, vocab_size=256, head_dim=0,
    )
