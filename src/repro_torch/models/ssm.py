"""Mamba-1 block (falcon-mamba-7b): depthwise causal conv and the selective
scan.  Counterpart of ``repro.models.ssm``.

The scan runs the CUDA ``selective_scan`` kernel (``ops.selective_scan``,
which forms the discretisation inside the kernel) where the config asks
for the kernels (``attn_impl="pallas"``), the tensors lie on a CUDA device
and autograd records nothing (the kernel has no backward); otherwise its
plain version (``ref.selective_scan_ref``), the JAX model's recurrence one
step at a time.  Both compute the same function.  Decode is a single
recurrence step carrying (conv_state, ssm_state), both written into the
cache in place.

Under a mesh the conv and the scan each run in a ``shard_map`` over this
rank's rows and channels (``channel_axes``: the decode cache's state
layout), so that the kernel sees local tensors and a decode's state writes
land in the cache's own local buffers, which a captured step replays.
``x_proj``'s rows are those channels, so ``u @ x_proj`` is a partial sum
over them, reduced before dt, B and C are sliced, as GSPMD does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.kernels.pricing import on_card

from .common import constrain, current_mesh_rules, to_dtensor


def use_scan_kernel(cfg, *ts) -> bool:
    """Whether a scan takes its CUDA kernel rather than the loop over time:
    the config asks for the kernels, the tensors lie on a CUDA device (or
    on ``meta`` under the cost model's ``pricing``), and autograd records
    none of them."""
    return (cfg.attn_impl == "pallas" and on_card(ts[0])
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in ts)))


def channel_axes(rules: dict):
    """The mesh axes the conv and the scans split their channels over under
    ``rules``: ``ff``'s, less any the batch is split over.  That is the
    decode cache's state layout (``launch.shardings.cache_pspecs``):
    ``model``, or in the batch-1 ``long`` layout every axis; under fsdp,
    whose batch takes every axis, none (None)."""
    from repro_torch.launch.shardings import off_batch

    return off_batch(rules, "ff")


def on_channels(x):
    """[B, S, C] activations under a mesh split over the batch rule and
    ``channel_axes`` (a reduce-scatter where ``x`` is a partial sum);
    outside one, ``x``."""
    ctx = current_mesh_rules()
    if ctx is None:
        return x
    from repro_torch.launch.shardings import PSpec, placements

    mesh, rules = ctx
    spec = PSpec(rules["batch"], None, channel_axes(rules))
    return to_dtensor(x, mesh).redistribute(mesh, placements(mesh, spec))


def channel_map(body, args: tuple, in_dims: tuple, out_dims: tuple):
    """``body(*args)`` on this rank's rows and channels: under a mesh a
    ``shard_map``, outside one ``body`` itself.  ``in_dims`` and
    ``out_dims``: per tensor, what each of its dims is split over, "b"
    (the batch rule's axes), "c" (``channel_axes``) or None (whole); an
    argument that is None stays None."""
    ctx = current_mesh_rules()
    if ctx is None:
        return body(*args)
    from repro_torch.launch.compat import shard_map
    from repro_torch.launch.shardings import PSpec

    mesh, rules = ctx
    axes = {"b": rules["batch"], "c": channel_axes(rules), None: None}

    def spec(dims):
        return PSpec(*(axes[d] for d in dims))

    in_specs = tuple(None if t is None else spec(d) for t, d in zip(args, in_dims))
    return shard_map(body, mesh, in_specs, tuple(spec(d) for d in out_dims))(*args)


def causal_conv(x, w, b, state=None):
    """``depthwise_causal_conv`` on this rank's channels (``channel_map``):
    x [B, S, C], w [C, K], b [C], state [B, K-1, C]; a given ``state`` (the
    decode's cache) is overwritten in place with the new one, which is
    returned."""

    def body(xl, wl, bl, sl):
        y, new = depthwise_causal_conv(xl, wl, bl, sl)
        if sl is not None:
            new = sl.copy_(new)
        return y, new

    rows = ("b", None, "c")
    return channel_map(body, (x, w, b, state), (rows, ("c", None), ("c",), rows), (rows, rows))


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
    decode's cache: the last state is written into it and returned.

    Under a mesh it runs on this rank's rows and channels (``channel_map``):
    u, dt, A, D and the state split on the channel dim, B_ssm and C_ssm
    whole."""

    def body(u, dt, A, B_ssm, C_ssm, D, h0):
        if kernel:
            return ops.selective_scan(u, dt, A, B_ssm, C_ssm, D, h0, h_out=h0)
        return ref.selective_scan_ref(u, dt, A, B_ssm, C_ssm, D, h0, h_out=h0)

    ch, rows, state = ("b", None, "c"), ("b", None, None), ("b", "c", None)
    return channel_map(body, (u, dt, A, B_ssm, C_ssm, D, h0),
                       (ch, ch, ("c", None), rows, rows, ("c",), state), (ch, state))


def mamba_block(x, p, cfg, compute_dtype, conv_state=None, ssm_state=None):
    """Full mamba-1 mixer. x [B, S, d] -> (y [B, S, d], new conv state
    [B, K-1, d_inner], new ssm state [B, d_inner, N] f32); a given
    ``conv_state`` and ``ssm_state`` (the decode's cache) are updated in
    place and returned."""
    cast = lambda w: w.to(compute_dtype)  # noqa: E731
    di = cfg.d_inner
    xz = x @ cast(p["in_proj"])  # [B, S, 2*di]
    x_in, z = xz[..., :di], xz[..., di:]
    x_in = on_channels(x_in)
    x_conv, new_conv = causal_conv(x_in, p["conv_w"], p.get("conv_b"), conv_state)
    u = F.silu(x_conv)
    # [B, S, R + 2N]: a sum over the channel shards under a mesh, reduced here
    proj = constrain(u @ cast(p["x_proj"]), "batch", "inner_seq", None)
    R, N = cfg.dt_rank, cfg.ssm_state
    dt_raw, B_ssm, C_ssm = proj[..., :R], proj[..., R : R + N], proj[..., R + N :]
    dt = ref.softplus(dt_raw @ cast(p["dt_w"]) + cast(p["dt_b"]))  # [B, S, di]
    A = -torch.exp(p["A_log"].float())
    kernel = use_scan_kernel(cfg, u, dt, p["A_log"], p["D"])
    y, h = selective_scan(u, dt, A, B_ssm, C_ssm, p["D"], h0=ssm_state, kernel=kernel)
    y = y * F.silu(z)
    out = y @ cast(p["out_proj"])
    return out, new_conv, h
