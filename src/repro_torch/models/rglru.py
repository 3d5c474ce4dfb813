"""RecurrentGemma building blocks: the RG-LRU recurrent (temporal-mix)
block.  Counterpart of ``repro.models.rglru``.

RG-LRU recurrence (Griffin / RecurrentGemma, arXiv:2402.19427):

  r_t = sigmoid(W_a x_t)                       (recurrence gate)
  i_t = sigmoid(W_x x_t)                       (input gate)
  log a_t = -c * softplus(Lambda) * r_t        (c = 8)
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Dense [lru, lru] gate matrices, as in the JAX package.  The recurrence and
its gates run the fused CUDA RG-LRU kernel (``ops.rglru_gated_scan``) where
the config asks for the kernels (``attn_impl="pallas"``), the tensors lie
on a CUDA device and autograd records nothing; otherwise its plain version
(``ref.rglru_gated_scan_ref``: the gates in eager f32 passes, then the loop
over time the JAX model runs).  Both compute the same function.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref

from .common import constrain
from .ssm import depthwise_causal_conv, use_scan_kernel


def rglru_scan(x, r, i, lam, h0=None, *, kernel: bool = False):
    """x, r, i: [B, S, W]; lam: [W]; h0 [B, W] f32 or None. Returns
    (y [B, S, W] in x's dtype, h_final [B, W] f32).

    With ``kernel`` the gates and the scan are ``ops.rglru_gated_scan`` (on
    the card: one kernel), else its plain version: the decay ``a`` and the
    gated input in f32, then the loop over time."""
    scan = ops.rglru_gated_scan if kernel else ref.rglru_gated_scan_ref
    return scan(x, r, i, lam, h0)


def recurrent_block(x, p, cfg, compute_dtype, conv_state=None, rec_state=None):
    """RecurrentGemma temporal-mix block.

    x [B, S, d] -> (out [B, S, d], new_conv_state, new_rec_state)."""
    cast = lambda w: w.to(compute_dtype)  # noqa: E731
    # y branch: linear + GELU (jax.nn.gelu is the tanh form)
    y_branch = F.gelu(x @ cast(p["wy"]), approximate="tanh")
    # x branch: linear -> causal conv -> RG-LRU
    xb = x @ cast(p["wx"])
    xb = constrain(xb, "batch", "inner_seq", "act_ff")
    xb, new_conv = depthwise_causal_conv(xb, p["conv_w"], p.get("conv_b"), conv_state)
    r = torch.sigmoid(xb @ cast(p["w_a"]))
    i = torch.sigmoid(xb @ cast(p["w_x"]))
    kernel = use_scan_kernel(cfg, xb, r, i, p["lam"])
    lru, new_rec = rglru_scan(xb, r, i, p["lam"], h0=rec_state, kernel=kernel)
    out = (lru * y_branch) @ cast(p["out_w"])
    return out, new_conv, new_rec
