"""qwen2-vl-2b [vlm]: M-RoPE, dynamic resolution — the vision frontend is a
STUB (input_specs provides precomputed patch embeddings + 3d position ids).
[arXiv:2409.12191; hf]"""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        family="dense",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab_size=151_936,
        norm="rmsnorm",
        mlp="swiglu",
        rope="mrope",  # multimodal rope: (t, h, w) sections over the head dim
        rope_theta=1_000_000.0,
        qkv_bias=True,
        embeds_input=True,  # patch/frame embeddings provided by the stub
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="qwen2vl-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab_size=128, head_dim=0,
    )
