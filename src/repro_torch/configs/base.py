"""Configuration system: model configs, shape configs, and the registry that
backs ``--arch <id>`` selection.

A copy of ``repro.configs.base`` (the port imports nothing of the JAX
package).  The registry holds the JAX package's ten architectures, in its
order; each ``<id>.py`` carries the exact published numbers and a
``smoke()`` reduction (same family, tiny dims).
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional

# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # components
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    mlp: str = "swiglu"  # swiglu | gelu
    rope: str = "default"  # default | half | mrope | none | sinusoidal
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    attn_out_bias: bool = False
    mlp_bias: bool = False
    qk_norm: bool = False  # per-head RMSNorm on q/k (qwen3)
    tie_embeddings: bool = False
    # modality frontend stub: model consumes precomputed embeddings
    embeds_input: bool = False

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # tokens per dispatch chunk: bounds the [T, E, C] dispatch tensors
    # (C scales with the chunk, so memory/flops stay O(chunk^2) per chunk)
    moe_chunk: int = 1024
    # dispatch implementation: "einsum" (one-hot matmul baseline) |
    # "scatter" (sort-free scatter dispatch — the §Perf hillclimb variant)
    moe_dispatch: str = "einsum"

    # SSM (mamba1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)

    # hybrid (recurrentgemma): block pattern, local attention window
    block_pattern: tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    local_window: int = 2048
    lru_width: int = 0  # 0 -> d_model

    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_positions: int = 1500  # post-conv-stub audio frames

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    kv_cache_dtype: str = ""  # "" -> compute_dtype; e.g. "float8_e4m3fn"

    # sequence parallelism: shard residual activations on seq over `model`
    # between blocks (all-reduce -> reduce-scatter/all-gather pairs)
    sequence_parallel: bool = False

    # parallelism layout for train/prefill:
    #   "tp"   — Megatron tensor parallelism over `model` (+ DP over data)
    #   "fsdp" — fully-sharded data parallelism: batch over every mesh axis,
    #            weights sharded over (data, model) and gathered per layer;
    #            collective volume scales with weights, not activations
    parallelism: str = "tp"

    # attention implementation: naive | chunked (online softmax in plain
    # PyTorch) | pallas (the name kept from the JAX package: the hand-written
    # CUDA flash-attention and flash-decode kernels on a CUDA device, their
    # plain versions on the CPU).  In the port "pallas" also routes the ssm
    # and hybrid families' scans to the CUDA mamba and RG-LRU scan kernels;
    # the other values run them as a loop over time
    # (``models/ssm.py:selective_scan``, ``models/rglru.py:rglru_scan``)
    attn_impl: str = "chunked"
    attn_chunk: int = 1024

    # remat policy for the layer scan: none | full | dots | save_collectives
    remat: str = "full"

    # logits/loss chunking over sequence (0 = no chunking)
    loss_chunk: int = 0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family == "ssm" and self.dt_rank == 0:
            object.__setattr__(self, "dt_rank", -(-self.d_model // 16))
        if self.family == "hybrid" and self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    # -- derived sizes ------------------------------------------------------

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def param_count(self) -> int:
        """Total parameter count N (embedding included once)."""
        from repro_torch.models.model import count_params_config

        return count_params_config(self)

    def active_param_count(self) -> int:
        """Parameters a token reads: the moe family's expert banks count
        ``experts_per_token / n_experts`` of their size."""
        from repro_torch.models.model import count_params_config

        return count_params_config(self, active_only=True)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Shape config (assigned input shapes)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

# long_500k requires sub-quadratic attention: only SSM/hybrid archs run it.
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def runnable_shapes(cfg: ModelConfig) -> list[ShapeConfig]:
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
            continue  # full-attention arch: skipped per assignment (DESIGN.md)
        out.append(s)
    return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# every architecture of ``repro.configs``, in its order
ARCH_IDS = (
    "whisper_large_v3",
    "chatglm3_6b",
    "yi_34b",
    "qwen1_5_4b",
    "minitron_8b",
    "qwen2_vl_2b",
    "recurrentgemma_2b",
    "qwen3_moe_30b_a3b",
    "granite_moe_1b_a400m",
    "falcon_mamba_7b",
)


def canonical_id(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical_id(arch)}")
    return mod.config()


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical_id(arch)}")
    return mod.smoke()


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
