"""falcon-mamba-7b [ssm]: mamba1 architecture, attention-free, ssm_state=16;
sub-quadratic -> runs long_500k. [arXiv:2410.05355; unverified]"""

from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        n_layers=64,
        d_model=4096,
        n_heads=1,  # unused by the SSM family
        n_kv_heads=1,
        head_dim=64,
        d_ff=0,  # the mamba block subsumes the MLP
        vocab_size=65_024,
        norm="rmsnorm",
        rope="none",
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
    )


def smoke() -> ModelConfig:
    return config().replace(
        name="mamba-smoke", n_layers=2, d_model=64, vocab_size=128,
        ssm_state=4, dt_rank=8,
    )
