"""qwen3-moe-30b-a3b [moe]: 128 experts, top-8, per-expert d_ff=768, QK-norm.
[hf:Qwen/Qwen3-30B-A3B; hf]"""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=768,  # per-expert intermediate
        vocab_size=151_936,
        norm="rmsnorm",
        mlp="swiglu",
        rope="default",
        rope_theta=1_000_000.0,
        n_experts=128,
        experts_per_token=8,
        qk_norm=True,
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="qwen3moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=32, vocab_size=128, n_experts=8, experts_per_token=2,
    )
