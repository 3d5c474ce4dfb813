"""Mamba-1 block (falcon-mamba-7b): depthwise causal conv and the selective
scan.  Counterpart of ``repro.models.ssm``.

The scan runs the CUDA ``selective_scan`` kernel (``ops.selective_scan``,
which forms the discretisation inside the kernel) where the config asks
for the kernels (``attn_impl="pallas"``), the tensors lie on a CUDA device
and autograd records nothing (the kernel has no backward); otherwise its
plain version (``ref.selective_scan_ref``), the JAX model's recurrence one
step at a time.  Both compute the same function.  Decode is a single
recurrence step carrying (conv_state, ssm_state); the decode updates the
cache's ssm state in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref

from .common import constrain


def use_scan_kernel(cfg, *ts) -> bool:
    """Whether a scan takes its CUDA kernel rather than the loop over time:
    the config asks for the kernels, the tensors lie on a CUDA device, and
    autograd records none of them."""
    return (cfg.attn_impl == "pallas" and ts[0].is_cuda
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in ts)))


def depthwise_causal_conv(x, w, b, state=None):
    """x [B, S, C], w [C, K] depthwise causal conv, as a sum of K shifted
    products (JAX's form; no cuDNN convolution, which runs in TF32 on the
    card by default).

    If ``state`` [B, K-1, C] is given (decode), it is the running tail of
    previous inputs.  Returns (y, new_state)."""
    B, S, C = x.shape
    K = w.shape[1]
    if state is None:
        ctx = F.pad(x, (0, 0, K - 1, 0))
    else:
        ctx = torch.cat([state.to(x.dtype), x], dim=1)
    wc = w.to(x.dtype)
    y = ctx[:, 0:S, :] * wc[:, 0]
    for j in range(1, K):
        y = y + ctx[:, j : j + S, :] * wc[:, j]
    if b is not None:
        y = y + b.to(x.dtype)
    new_state = ctx[:, S:, :] if K > 1 else x.new_zeros((B, 0, C))
    return y, new_state


def selective_scan(u, dt, A, B_ssm, C_ssm, D, h0=None, *, kernel: bool = False):
    """The mamba-1 SSM recurrence.

    u      [B, S, C]   (post-conv activations)
    dt     [B, S, C]   (softplus'd step sizes)
    A      [C, N]      (negative; A = -exp(A_log))
    B_ssm  [B, S, N]
    C_ssm  [B, S, N]
    D      [C]
    h0     [B, C, N] f32 initial state (decode: the cache, updated in place) or None

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) outer B_t
    y_t = (h_t . C_t) + D * u_t
    returns (y [B, S, C] in u's dtype, h_final [B, C, N] f32).

    With ``kernel`` it runs ``ops.selective_scan`` (on the card: one kernel
    that forms dA_t and dBu_t per step in registers), without it the plain
    loop over time; both form dA_t and dBu_t per step, as the JAX model
    does, and never the [B, S, C, N] tensors.  A given ``h0`` is the
    decode's cache: the last state is written into it and returned."""
    if kernel:
        return ops.selective_scan(u, dt, A, B_ssm, C_ssm, D, h0, h_out=h0)
    return ref.selective_scan_ref(u, dt, A, B_ssm, C_ssm, D, h0, h_out=h0)


def mamba_block(x, p, cfg, compute_dtype, conv_state=None, ssm_state=None):
    """Full mamba-1 mixer. x [B, S, d] -> (y [B, S, d], new conv state
    [B, K-1, d_inner], new ssm state [B, d_inner, N] f32); a given
    ``ssm_state`` (the decode's cache) is updated in place and returned."""
    cast = lambda w: w.to(compute_dtype)  # noqa: E731
    di = cfg.d_inner
    xz = x @ cast(p["in_proj"])  # [B, S, 2*di]
    x_in, z = xz[..., :di], xz[..., di:]
    x_in = constrain(x_in, "batch", "inner_seq", "act_ff")
    x_conv, new_conv = depthwise_causal_conv(x_in, p["conv_w"], p.get("conv_b"), conv_state)
    u = F.silu(x_conv)
    proj = u @ cast(p["x_proj"])  # [B, S, R + 2N]
    R, N = cfg.dt_rank, cfg.ssm_state
    dt_raw, B_ssm, C_ssm = proj[..., :R], proj[..., R : R + N], proj[..., R + N :]
    dt = ref.softplus(dt_raw @ cast(p["dt_w"]) + cast(p["dt_b"]))  # [B, S, di]
    A = -torch.exp(p["A_log"].float())
    kernel = use_scan_kernel(cfg, u, dt, p["A_log"], p["D"])
    y, h = selective_scan(u, dt, A, B_ssm, C_ssm, p["D"], h0=ssm_state, kernel=kernel)
    y = y * F.silu(z)
    out = y @ cast(p["out_proj"])
    return out, new_conv, h
