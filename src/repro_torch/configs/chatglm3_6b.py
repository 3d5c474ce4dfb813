"""chatglm3-6b [dense]: GQA kv=2, 2d-RoPE (rotary applied to half the head
dim), QKV bias. [arXiv:2406.12793; hf]"""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        n_layers=28,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_ff=13_696,
        vocab_size=65_024,
        norm="rmsnorm",
        mlp="swiglu",
        rope="half",  # ChatGLM's 2d rope: rotate only half of each head dim
        rope_theta=10_000.0,
        qkv_bias=True,
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="chatglm3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab_size=128, head_dim=0,
    )
