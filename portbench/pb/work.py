"""The work a step needs, counted from the configuration's shapes, and the
chip's peaks: the yardstick of every roofline and mfu metric.

Counts are of what the algorithm needs, not of what an implementation
does: each weight a step reads is counted once, each key and value up to a
row's length once, and the FLOPs of the products a token goes through (2
per multiply-add).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core FLOP/s and HBM3 bytes/s
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16 = 2


def attn_weights(cfg: dict) -> int:
    d, qd, kvd = cfg["d_model"], cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]
    n = 2 * d * qd + 2 * d * kvd
    if cfg["qkv_bias"]:
        n += qd + 2 * kvd
    if cfg["qk_norm"]:
        n += 2 * cfg["head_dim"]
    return n


def mlp_weights(cfg: dict) -> int:
    """The SwiGLU MLP's parameters."""
    return 3 * cfg["d_model"] * cfg["d_ff"]


def token_flops(cfg: dict) -> int:
    """The products one token goes through in the layers (no attention
    scores, no head)."""
    d, L = cfg["d_model"], cfg["n_layers"]
    return 2 * L * (2 * d * cfg["n_heads"] * cfg["head_dim"] + 2 * d * cfg["n_kv_heads"] * cfg["head_dim"]
                    + mlp_weights(cfg))


def head_flops(cfg: dict) -> int:
    return 2 * cfg["d_model"] * cfg["vocab_size"]


def attn_flops(cfg: dict, keys: int) -> int:
    """Scores and weighted values of one query over ``keys`` keys, all layers."""
    return 4 * cfg["n_layers"] * cfg["n_heads"] * cfg["head_dim"] * keys


def prefill_attn_flops(cfg: dict, S: int) -> int:
    """A causal prefill of S tokens: query i sees i + 1 keys."""
    return attn_flops(cfg, S * (S + 1) // 2)


def prefill_flops(cfg: dict, S: int) -> int:
    """A batch-1 prefill of S tokens, the head at the last one only."""
    return S * token_flops(cfg) + prefill_attn_flops(cfg, S) + head_flops(cfg)


def kv_row_bytes(cfg: dict) -> int:
    """One position's key and value in one layer (bf16)."""
    return 2 * cfg["n_kv_heads"] * cfg["head_dim"] * BF16


def tick_work(cfg: dict, kv_lens: list) -> tuple[float, float]:
    """(FLOPs, bytes) one decode step needs for the busy rows at ``kv_lens``
    (each row's keys, its new token's included): every layer weight read
    once, the head, the rows' embeddings, their earlier keys and values
    read and the new ones written, and the f32 logits."""
    d, L, V = cfg["d_model"], cfg["n_layers"], cfg["vocab_size"]
    n = len(kv_lens)
    flops = n * (token_flops(cfg) + head_flops(cfg)) + attn_flops(cfg, sum(kv_lens))
    weights = L * (attn_weights(cfg) + 2 * d + mlp_weights(cfg)) + d + d * V
    cache = L * kv_row_bytes(cfg) * sum(kv_lens)  # the old ones read, the new one written
    return flops, weights * BF16 + n * d * BF16 + cache + n * V * 4


def decode_attention_bytes(cfg: dict, kv_lens: list) -> int:
    """One flash-decode call over every row at ``kv_lens``: q and o read
    and written once, each row's keys and values up to its length."""
    qo = 2 * len(kv_lens) * cfg["n_heads"] * cfg["head_dim"] * BF16
    return qo + kv_row_bytes(cfg) * sum(kv_lens)
