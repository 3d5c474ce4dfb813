"""Public attention ops in the model layouts, counterpart of
``repro.kernels.ops`` (``flash_attention``, ``decode_attention``).

Each op chooses by the device of the tensors it is given: a CPU tensor
takes the plain PyTorch version (``ref``), a CUDA tensor the hand-written
CUDA kernel, which raises on what it cannot take.  There is no fallback
from the kernel to the plain version.
"""

from __future__ import annotations

from . import ref
from .decode_attention import decode_attention_fwd
from .flash_attention import flash_attention_fwd


def flash_attention(q, k, v, *, causal=True, q_offset=0, with_lse=False):
    """q [B, Sq, H, D]; k, v [B, Sk, KV, D] -> [B, Sq, H, D] (and the f32
    log-sum-exp [B*H, Sq] when ``with_lse``).

    There are no block-size options: the CUDA kernel fixes its own tiles and
    masks ragged edges, so it takes any Sq and Sk."""
    if q.is_cuda:
        o, lse = flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset)
        return (o, lse) if with_lse else o
    return ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                   return_lse=with_lse)


def decode_attention(q, k, v, kv_len):
    """q [B, H, D]; k, v [B, S, KV, D]; kv_len scalar -> [B, H, D].

    The cache is read in place (no head-major copy).  The kernel fixes its
    own tiles, so any S is taken: the JAX wrapper's
    ``S % min(block_k, S) == 0`` assertion has no counterpart here."""
    if q.is_cuda:
        return decode_attention_fwd(q, k, v, int(kv_len))
    return ref.decode_attention_ref(q, k, v, kv_len)
