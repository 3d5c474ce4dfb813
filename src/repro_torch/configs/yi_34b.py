"""yi-34b [dense]: llama-architecture GQA. [arXiv:2403.04652; hf]"""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b",
        family="dense",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20_480,
        vocab_size=64_000,
        norm="rmsnorm",
        mlp="swiglu",
        rope="default",
        rope_theta=5_000_000.0,
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="yi-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=192, vocab_size=128, head_dim=0,
    )
