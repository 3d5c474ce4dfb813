"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, pattern
(rec, rec, attn); sub-quadratic -> runs long_500k. [arXiv:2402.19427; hf]"""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256_000,
        norm="rmsnorm",
        mlp="geglu",
        rope="default",
        rope_theta=10_000.0,
        block_pattern=("rec", "rec", "attn"),
        local_window=2048,
        lru_width=2560,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="rg-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=128, local_window=8, lru_width=64,
    )
