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

Under a mesh the conv and the scan run on this rank's rows and lru
channels (``ssm.channel_map``, as the mamba block's): x, r, i, lam and the
recurrent state split on the lru dim.  ``w_a`` and ``w_x``'s rows are those
channels, so r and i's products are partial sums, reduced (onto the same
channels) before the sigmoid.  A decode writes its conv and recurrent
states into the cache in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref

from .ssm import causal_conv, channel_map, on_channels, use_scan_kernel


def rglru_scan(x, r, i, lam, h0=None, *, kernel: bool = False):
    """x, r, i: [B, S, W]; lam: [W]; h0 [B, W] f32 or None. Returns
    (y [B, S, W] in x's dtype, h_final [B, W] f32).

    With ``kernel`` the gates and the scan are ``ops.rglru_gated_scan`` (on
    the card: one kernel), else its plain version: the decay ``a`` and the
    gated input in f32, then the loop over time.  A given ``h0`` (the
    decode's cache) is overwritten in place with the last state, which is
    returned.  Under a mesh it runs on this rank's rows and lru channels."""
    scan = ops.rglru_gated_scan if kernel else ref.rglru_gated_scan_ref

    def body(x, r, i, lam, h0):
        y, h = scan(x, r, i, lam, h0)
        return y, (h if h0 is None else h0.copy_(h))

    ch = ("b", None, "c")
    return channel_map(body, (x, r, i, lam, h0), (ch, ch, ch, ("c",), ("b", "c")),
                       (ch, ("b", "c")))


def recurrent_block(x, p, cfg, compute_dtype, conv_state=None, rec_state=None):
    """RecurrentGemma temporal-mix block.

    x [B, S, d] -> (out [B, S, d], new_conv_state, new_rec_state); a given
    ``conv_state`` and ``rec_state`` (the decode's cache) are updated in
    place and returned."""
    cast = lambda w: w.to(compute_dtype)  # noqa: E731
    # y branch: linear + GELU (jax.nn.gelu is the tanh form)
    y_branch = F.gelu(x @ cast(p["wy"]), approximate="tanh")
    # x branch: linear -> causal conv -> RG-LRU
    xb = x @ cast(p["wx"])
    xb, new_conv = causal_conv(on_channels(xb), p["conv_w"], p.get("conv_b"), conv_state)
    r = torch.sigmoid(on_channels(xb @ cast(p["w_a"])))
    i = torch.sigmoid(on_channels(xb @ cast(p["w_x"])))
    kernel = use_scan_kernel(cfg, xb, r, i, p["lam"])
    lru, new_rec = rglru_scan(xb, r, i, p["lam"], h0=rec_state, kernel=kernel)
    out = (lru * y_branch) @ cast(p["out_w"])
    return out, new_conv, new_rec
