"""Public kernel ops in the model layouts, counterpart of
``repro.kernels.ops`` (``flash_attention``, ``flash_attention_trainable``,
``decode_attention``, ``prefetch_gather``, ``rglru_scan``, ``mamba_scan``),
and the two fused scans the recurrent models run: ``selective_scan`` (the
JAX model's ``repro.models.ssm.selective_scan``) and ``rglru_gated_scan``
(``repro.models.rglru.rglru_scan``).

Each op chooses by the device of the tensors it is given: a CPU tensor
takes the plain PyTorch version (``ref``), a CUDA tensor the hand-written
CUDA kernel, which raises on what it cannot take.  There is no fallback
from the kernel to the plain version.  A ``meta`` tensor takes the plain
version too (the access plan traces it), except under the cost model's
``pricing`` context, where it takes the card's route and each kernel is
priced instead of launched (``pricing.on_card``).
"""

from __future__ import annotations

import torch

from . import pricing, ref
from .decode_attention import decode_attention_fwd
from .flash_attention import flash_attention_fwd
from .flash_attention_bwd import attention_delta, flash_attention_bwd
from .mamba_scan import mamba_scan_fwd
from .prefetch_gather import prefetch_gather_fwd
from .rglru_scan import rglru_gated_fwd, rglru_scan_fwd
from .selective_scan import selective_scan_fwd


def flash_attention(q, k, v, *, causal=True, q_offset=0, with_lse=False):
    """q [B, Sq, H, D]; k, v [B, Sk, KV, D] -> [B, Sq, H, D] (and the f32
    log-sum-exp [B*H, Sq] when ``with_lse``).

    There are no block-size options: the CUDA kernel fixes its own tiles and
    masks ragged edges, so it takes any Sq and Sk."""
    if pricing.on_card(q):
        q, k, v = (_waited(t) for t in (q, k, v))
        o, lse = flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset)
        return (o, lse) if with_lse else o
    return ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                   return_lse=with_lse)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the forward kernel emits (o, lse);
    the backward runs the dK/dV and dQ kernels, which recompute the scores
    from q, k, v and lse, so no [Sq, Sk] tensor is kept between the two."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        o, lse = flash_attention(q, k, v, causal=causal, q_offset=q_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = _waited(do)
        kw = dict(causal=ctx.causal, q_offset=ctx.q_offset)
        if pricing.on_card(q):
            dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, **kw)
        else:
            dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, do, lse, attention_delta(o, do),
                                                     **kw)
        return dq, dk, dv, None, None


def _waited(t):
    """``t`` as a plain tensor, for a kernel that takes raw pointers.  Under
    a mesh a cotangent can arrive as an ``AsyncCollectiveTensor`` (the
    result of a collective not yet waited on), which is waited on; a
    DTensor (a whole sharded tensor) raises: the kernels take each rank's
    local shard (``launch.compat.shard_map``)."""
    if type(t) is not torch.Tensor and torch.distributed.is_available():
        from torch.distributed._functional_collectives import AsyncCollectiveTensor
        from torch.distributed.tensor import DTensor

        if isinstance(t, AsyncCollectiveTensor):
            return t.wait()
        if isinstance(t, DTensor):
            raise TypeError("a DTensor reached a kernel wrapper; the kernels take local "
                            "shards (run the model under models.common.activate_sharding)")
    return t


def _local(*ts) -> tuple:
    """``_waited`` of each tensor given (None stays None): what every kernel
    wrapper applies on the card, so that no DTensor reaches a kernel."""
    return tuple(None if t is None else _waited(t) for t in ts)


def flash_attention_trainable(q, k, v, causal=True, q_offset=0):
    """Differentiable ``flash_attention``: q [B, Sq, H, D]; k, v [B, Sk, KV,
    D] -> [B, Sq, H, D].  Its gradients are dq in q's layout and dk, dv per
    KV head, each group of query heads summed in f32 (the TPU wrapper sums
    per-head gradients already rounded to k's dtype)."""
    return _FlashAttention.apply(q, k, v, causal, q_offset)


def decode_attention(q, k, v, kv_len, with_lse: bool = False):
    """q [B, H, D]; k, v [B, S, KV, D]; kv_len a Python int, a one-element
    int32 tensor on q's device (the TPU kernel's scalar-prefetch operand) or
    a ``[B]`` int32 tensor there (one length per batch row: the continuous
    batcher's slots) -> [B, H, D]; with ``with_lse`` also the f32
    log-sum-exp [B, H] of each head's scaled, masked scores (the kernel's
    extension past the TPU kernel, for merging caches that split one
    sequence).  A tensor goes to the kernel as it is, never read on the
    host, so a captured decode step replays at any length.

    The cache is read in place (no head-major copy).  The kernel fixes its
    own tiles, so any S is taken: the JAX wrapper's
    ``S % min(block_k, S) == 0`` assertion has no counterpart here."""
    if pricing.on_card(q):
        q, k, v = _local(q, k, v)
        return decode_attention_fwd(q, k, v, kv_len, with_lse)
    return ref.decode_attention_ref(q, k, v, kv_len, with_lse)


def prefetch_gather(table, idx):
    """table [N, D]; idx [B] int32 or int64 -> [B, D] = table[idx], for any D
    and dtype: the JAX wrapper pads D to a multiple of 128 and slices the
    result back, the CUDA kernel copies rows of any width as they are.  The
    indices stay on the device (no ``.item()``, no host range check)."""
    if pricing.on_card(table):
        return prefetch_gather_fwd(*_local(table, idx))
    return ref.prefetch_gather_ref(table, idx)


def rglru_scan(a, g, h0=None):
    """a, g [B, S, W]; h0 [B, W] f32 or None (zeros) -> y [B, S, W] in a's
    dtype: h_t = a_t * h_{t-1} + g_t, y_t = h_t, with an f32 state.

    The CUDA kernel reads the model's layout as it is; the JAX wrapper folds
    batch into channels ([S, B * W]), has no h0 and takes block sizes, which
    have no counterpart here (the kernel takes any S and W)."""
    if pricing.on_card(a):
        return rglru_scan_fwd(*_local(a, g, h0))
    return ref.rglru_scan_ref(a, g, h0)


def mamba_scan(dA, dBu, C, h0=None, with_state=False):
    """dA, dBu [B, S, Ch, N]; C [B, S, N]; h0 [B, Ch, N] f32 or None (zeros)
    -> y [B, S, Ch] in dA's dtype: h_t = dA_t * h_{t-1} + dBu_t, y_t = h_t .
    C_t, with an f32 state; with ``with_state``, (y, h_S [B, Ch, N] f32).

    The JAX wrapper vmaps batch over the TPU kernel, which starts from zero
    and drops its last state; the CUDA kernel takes h0 and returns h_S,
    what the model's prefill and decode need, and any S and Ch."""
    if pricing.on_card(dA):
        return mamba_scan_fwd(*_local(dA, dBu, C, h0), with_state)
    return ref.mamba_scan_ref(dA, dBu, C, h0, with_state)


def selective_scan(u, dt, A, B_ssm, C_ssm, D, h0=None, *, h_out=None):
    """The mamba-1 selective scan with its discretisation: u, dt [B, S, Ch];
    A [Ch, N] f32; B_ssm, C_ssm [B, S, N]; D [Ch] f32; h0 [B, Ch, N] f32 or
    None (zeros) -> (y [B, S, Ch] in u's dtype, h_S [B, Ch, N] f32).  With
    ``h_out`` the last state is written there (it may be ``h0``: updated in
    place, as the model's decode does with its cache).

    On the card dA = exp(dt A) and dBu = (dt u) B are formed inside the
    kernel, per step, as the JAX model forms them inside its ``lax.scan``;
    ``mamba_scan`` is the TPU kernel's contract, with both materialised."""
    if pricing.on_card(u):
        u, dt, A, B_ssm, C_ssm, D, h0, h_out = _local(u, dt, A, B_ssm, C_ssm, D, h0, h_out)
        return selective_scan_fwd(u, dt, A, B_ssm, C_ssm, D, h0, h_out=h_out)
    return ref.selective_scan_ref(u, dt, A, B_ssm, C_ssm, D, h0, h_out=h_out)


def rglru_gated_scan(x, r, i, lam, h0=None):
    """The RG-LRU with its gates: x, r, i [B, S, W]; lam [W]; h0 [B, W] f32 or
    None (zeros) -> (y [B, S, W] in x's dtype, h_S [B, W] f32), with a_t =
    exp(-8 softplus(lam) r_t) and h_t = a_t h_{t-1} + sqrt(1 - a_t^2)
    (i_t x_t).  On the card the gates are formed inside the kernel; the
    decay coefficient -8 softplus(lam) is formed here with the plain
    version's ops, so both round it alike."""
    if pricing.on_card(x):
        x, r, i, lam, h0 = _local(x, r, i, lam, h0)
        return rglru_gated_fwd(x, r, i, ref.rglru_decay(lam), h0)
    return ref.rglru_gated_scan_ref(x, r, i, lam, h0)
