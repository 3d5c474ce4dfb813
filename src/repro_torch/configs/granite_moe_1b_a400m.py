"""granite-moe-1b-a400m [moe]: 32 experts, top-8, per-expert d_ff=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_ff=512,  # per-expert intermediate
        vocab_size=49_155,
        norm="rmsnorm",
        mlp="swiglu",
        rope="default",
        rope_theta=10_000.0,
        n_experts=32,
        experts_per_token=8,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="granitemoe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab_size=128, n_experts=4, experts_per_token=2, head_dim=0,
    )
