"""Mixture-of-Experts layer on one device.  Counterpart of
``repro.models.moe``: the router, the capacity-based dispatch in both of its
modes (one-hot einsums, the default, and the scatter variant), the expert
FFN and the combine, with the JAX package's names and numerics.

CAPre mapping: the router's top-k choice is the paper's *branch-dependent
navigation*, decided at run time; the access plan prefetches the statically
known superset, every layer's whole expert bank.  At decode (T = B tokens)
the capacity is ``max(1, int(1.25 * T * k / E))`` = 1 for both configs, so
the expert products read every expert's weights each step, as the JAX path
does.

Capacity and drops are JAX's: a token's slot in an expert's buffer is its
rank among the (token, choice) pairs routed to that expert, in token-major
order, and pairs ranked past the capacity are dropped, so at decode a token
that meets an earlier token on an expert loses that expert.  One-hots are
comparisons with an ``arange`` (out-of-range indices give zero rows, as
``jax.nn.one_hot`` does).  Nothing reads a value back on the host and no
shape depends on the data, so the decode step can be captured in a CUDA
graph.

Ties in top-k: ``jax.lax.top_k`` returns equal values in index order;
``torch.topk`` does not say which of equal values comes first.  Exact ties
of f32 softmax probabilities need equal router logits, which random inputs
do not give.

Under a mesh (``mesh_info``), three more paths, each a ``shard_map`` on
the ranks' local shards, as in JAX:

  * ``moe_apply_ep``: activations replicated over ``model``; each rank
    routes all of its data shard's tokens but dispatches only to its local
    experts (E / n_model); the combine is a sum over ``model``;
  * ``moe_apply_fsdp``: tokens never leave their rank; the expert banks are
    gathered (the FSDP weight all-gather) and each rank runs the dense path
    on its tokens;
  * ``moe_apply_ep_a2a``: tokens sharded over every axis; each rank routes
    its own tokens (scatter dispatch) and exchanges capacity buffers with
    the expert shards by a pair of all-to-alls over ``model``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.compat import shard_map
from repro_torch.launch.shardings import PSpec, placements


def _one_hot(idx, n: int):
    """f32 one-hot of ``idx`` over ``n`` classes; values outside [0, n) give
    zero rows (``jax.nn.one_hot``; ``F.one_hot`` raises on them)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def router_topk(x2d, router_w, n_experts: int, k: int, router_dtype=torch.float32):
    """x2d [T, d] -> (probs [T, k], idx [T, k]): softmax over all experts in
    ``router_dtype`` (f32), keep the top k, renormalise (qwen3 and granite
    style).  JAX's ``_route_dispatch_ffn`` calls it with the default dtype,
    whatever ``cfg.router_dtype`` says, and so does this module."""
    logits = x2d.to(router_dtype) @ router_w.to(router_dtype)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_i


def _ranks(top_i, n_experts: int):
    """(one-hot [T, k, E], rank [T, k]): each (token, choice) pair's rank
    among the pairs routed to its expert before it, in token-major order
    (``cumsum - self`` over the flattened [T * k, E] one-hot, in f32 as in
    JAX: exact for up to 2^24 pairs).  The sum runs along the last dim of
    the transposed one-hot, which CUDA scans a row per block; along the
    first dim each expert's column is scanned serially, which took most of
    granite's prefill on an H100."""
    T, k = top_i.shape
    oh = _one_hot(top_i, n_experts)
    flat = oh.reshape(T * k, n_experts).T.contiguous()  # [E, T * k]
    ranks = (torch.cumsum(flat, dim=1) - flat).T.reshape(T, k, n_experts)
    return oh, (ranks * oh).sum(-1)


def _dispatch_onehot(top_i, top_p, n_experts: int, capacity: int):
    """Dispatch and combine tensors [T, E, C] in f32: ``disp[t, e, c]`` is 1
    where token t's choice of expert e took slot c, ``comb`` holds that
    choice's gate there; choices past the capacity, or of an expert outside
    [0, E), are dropped.

    JAX builds the one-hot [T, k, E, C] and sums it over k (336 MB per
    1024-token chunk at qwen3's widths).  A token's k choices are distinct
    experts, so each (t, e) gets at most one term of that sum, and the
    values written here with a scatter are bitwise JAX's: 1, or the one
    gate plus zeros."""
    T, k = top_i.shape
    oh, rank = _ranks(top_i, n_experts)
    valid = (oh.sum(-1) > 0) & (rank < capacity)
    slot = torch.where(valid, top_i * capacity + rank.long(), n_experts * capacity)
    width = n_experts * capacity + 1  # the last column takes the dropped choices
    disp = torch.zeros((T, width), dtype=torch.float32, device=top_i.device)
    comb = torch.zeros((T, width), dtype=torch.float32, device=top_i.device)
    disp.scatter_(1, slot, valid.float())
    comb.scatter_(1, slot, torch.where(valid, top_p.float(), 0.0))
    shape = (T, n_experts, capacity)
    return disp[:, :-1].reshape(shape), comb[:, :-1].reshape(shape)


def _expert_ffn(xe, we_gate, we_up, we_down, compute_dtype):
    """xe [E, C, d] -> [E, C, d]: each expert's gated MLP, batched over E."""
    g = torch.bmm(xe, we_gate.to(compute_dtype))
    u = torch.bmm(xe, we_up.to(compute_dtype))
    return torch.bmm(F.silu(g) * u, we_down.to(compute_dtype))


def _dispatch_scatter(x2, local_i, top_p, n_local: int, cap: int, compute_dtype):
    """Scatter dispatch: each (token, choice) row copied into its slot of
    the [E * C, d] buffer, no dispatch product.  Returns (buffer [E * C, d],
    slot [T, k], valid [T, k], rank [T, k]); an invalid choice's slot is the
    overflow row E * C, which the buffer leaves out."""
    T, k = local_i.shape
    _, rank = _ranks(local_i, n_local)
    rank = rank.to(torch.int32)
    valid = (local_i >= 0) & (local_i < n_local) & (rank < cap)
    slot = torch.where(valid, local_i * cap + rank, n_local * cap)
    d = x2.shape[1]
    buf = torch.zeros((n_local * cap + 1, d), dtype=compute_dtype, device=x2.device)
    xk = x2[:, None, :].expand(T, k, d).reshape(T * k, d).to(compute_dtype)
    # valid slots are distinct; only the overflow row is written twice
    buf.index_copy_(0, slot.reshape(-1).long(), xk)
    return buf[:-1], slot, valid, rank


def _route_dispatch_ffn(x2, router_w, we_gate, we_up, we_down, cfg, compute_dtype,
                        expert_offset=0, n_local: int = 0):
    """Route the tokens x2 [T, d] in chunks of up to ``cfg.moe_chunk``
    (halved until it divides T), dispatch each chunk to the expert slice
    [expert_offset, expert_offset + n_local) (all E experts by default; a
    choice outside the slice is dropped), run the expert FFN and combine:
    the (partial) output [T, d].  The chunks run one after another, as
    JAX's ``lax.map`` runs them."""
    E, k = cfg.n_experts, cfg.experts_per_token
    n_local = n_local or E
    T, d = x2.shape
    chunk = min(cfg.moe_chunk, T)
    while T % chunk:
        chunk //= 2
    cap = max(1, int(cfg.capacity_factor * chunk * k / E))

    def one_chunk(xc):
        top_p, top_i = router_topk(xc, router_w, E, k)
        local_i = top_i - expert_offset  # out of the slice -> out of range -> dropped
        if cfg.moe_dispatch == "scatter":
            xe_flat, slot, valid, _ = _dispatch_scatter(xc, local_i, top_p, n_local, cap,
                                                        compute_dtype)
            ye = _expert_ffn(xe_flat.reshape(n_local, cap, d), we_gate, we_up, we_down,
                             compute_dtype)
            gathered = ye.reshape(n_local * cap, d)[torch.where(valid, slot, 0).long()]
            w = torch.where(valid, top_p, 0.0).to(compute_dtype)
            return torch.einsum("tkd,tk->td", gathered, w)
        disp, comb = _dispatch_onehot(local_i, top_p, n_local, cap)
        n = xc.shape[0]
        xe = disp.to(compute_dtype).reshape(n, n_local * cap).T @ xc
        ye = _expert_ffn(xe.reshape(n_local, cap, d), we_gate, we_up, we_down, compute_dtype)
        return comb.to(compute_dtype).reshape(n, n_local * cap) @ ye.reshape(n_local * cap, d)

    if chunk == T:
        return one_chunk(x2)
    return torch.cat([one_chunk(xc) for xc in x2.split(chunk)])


def moe_apply_dense(x, p, cfg, compute_dtype):
    """The single-device path. x [B, S, d] -> [B, S, d]."""
    B, S, d = x.shape
    y = _route_dispatch_ffn(x.reshape(B * S, d), p["router"], p["we_gate"], p["we_up"],
                            p["we_down"], cfg, compute_dtype)
    return y.reshape(B, S, d)


def _banks(p):
    return p["router"], p["we_gate"], p["we_up"], p["we_down"]


def moe_apply_ep(x, p, cfg, compute_dtype, mesh, data_axes, model_axis: str):
    """Expert-parallel path (see the module docstring).  Each rank's output
    is the part of its local experts, ``Partial`` over ``model``; the sum
    (JAX's ``psum``) is DTensor's differentiable all-reduce."""
    E_local = cfg.n_experts // mesh.size(mesh.mesh_dim_names.index(model_axis))

    def body(xl, router_w, wg, wu, wd):
        Bl, S, d = xl.shape
        offset = mesh.get_local_rank(model_axis) * E_local
        y = _route_dispatch_ffn(xl.reshape(Bl * S, d), router_w, wg, wu, wd, cfg,
                                compute_dtype, expert_offset=offset, n_local=E_local)
        return y.reshape(Bl, S, d)

    dspec = PSpec(data_axes, None, None)
    bank = PSpec(model_axis, None, None)
    y = shard_map(body, mesh, (dspec, PSpec(None, None), bank, bank, bank), dspec,
                  out_partial=(model_axis,))(x, *_banks(p))
    return y.redistribute(mesh, placements(mesh, dspec))


def moe_apply_fsdp(x, p, cfg, compute_dtype, mesh, batch_axes):
    """FSDP-local path: tokens never leave their rank; the expert banks
    arrive gathered (the per-layer FSDP weight all-gather) and every rank
    runs the dense dispatch on its local tokens, with no collective."""

    def body(xl, router_w, wg, wu, wd):
        Bl, S, d = xl.shape
        y = _route_dispatch_ffn(xl.reshape(Bl * S, d), router_w, wg, wu, wd, cfg,
                                compute_dtype)
        return y.reshape(Bl, S, d)

    bspec = PSpec(batch_axes, None, None)
    rep2, rep3 = PSpec(None, None), PSpec(None, None, None)
    return shard_map(body, mesh, (bspec, rep2, rep3, rep3, rep3), bspec)(x, *_banks(p))


def moe_apply_ep_a2a(x, p, cfg, compute_dtype, mesh, batch_axes, model_axis):
    """Switch/DeepSpeed-style expert parallelism: tokens sharded over every
    mesh axis; each rank routes its own tokens (scatter dispatch) and
    exchanges its [E, C, d] capacity buffers with the expert shards over
    ``model``: a tiled all-to-all (expert blocks scatter, capacity gathers),
    the local experts' FFN on [E_local, n * C, d], and the all-to-all back.
    Both exchanges are ``all_to_all_single`` with autograd (the backward is
    the reverse exchange)."""
    import torch.distributed._functional_collectives as funcol

    E, k = cfg.n_experts, cfg.experts_per_token
    n = mesh.size(mesh.mesh_dim_names.index(model_axis))
    E_local = E // n
    group = mesh.get_group(model_axis)

    def a2a(t):
        return funcol.wait_tensor(funcol.all_to_all_single_autograd(t, None, None, group))

    def body(xl, router_w, wg, wu, wd):
        Bl, S, d = xl.shape
        x2 = xl.reshape(Bl * S, d)
        T = x2.shape[0]
        cap = max(1, int(cfg.capacity_factor * T * k / E))
        top_p, top_i = router_topk(x2, router_w, E, k)
        buf, slot, valid, _ = _dispatch_scatter(x2, top_i, top_p, E, cap, compute_dtype)
        # [E, cap, d] = [n shards, E_local, cap, d]: block j to shard j; what
        # comes back is [n origins, E_local, cap, d], the origins along capacity
        xe = a2a(buf.reshape(E, cap, d))
        xe = xe.reshape(n, E_local, cap, d).transpose(0, 1).reshape(E_local, n * cap, d)
        ye = _expert_ffn(xe, wg, wu, wd, compute_dtype)
        ye = ye.reshape(E_local, n, cap, d).transpose(0, 1).contiguous()
        ye = a2a(ye.reshape(E, cap, d)).reshape(E * cap, d)
        ye_flat = torch.cat([ye, ye.new_zeros(1, d)])
        gathered = ye_flat[torch.where(valid, slot, E * cap).long()]  # [T, k, d]
        w = torch.where(valid, top_p, 0.0).to(compute_dtype)
        return torch.einsum("tkd,tk->td", gathered, w).reshape(Bl, S, d)

    bspec = PSpec(batch_axes, None, None)
    bank = PSpec(model_axis, None, None)
    return shard_map(body, mesh, (bspec, PSpec(None, None), bank, bank, bank), bspec)(
        x, *_banks(p))


def moe_apply(x, p, cfg, compute_dtype, mesh_info=None):
    """Dispatch to the dense / EP-sum / fsdp-local / EP-a2a path, as JAX's
    ``moe_apply`` does: ``mesh_info`` is (mesh, data axes, model axis[,
    "ep_a2a"]) from ``launch.steps.mesh_info_for``; a model axis of None
    selects the fsdp-local path, an axis that does not divide the experts
    the dense one (on a mesh's DTensors: ``_dense_on_mesh``)."""
    if mesh_info is not None:
        mesh, data_axes, model_axis = mesh_info[:3]
        mode = mesh_info[3] if len(mesh_info) > 3 else "ep_psum"
        if model_axis is None:
            return moe_apply_fsdp(x, p, cfg, compute_dtype, mesh, data_axes)
        n_model = mesh.size(mesh.mesh_dim_names.index(model_axis))
        if n_model > 1 and cfg.n_experts % n_model == 0:
            if mode == "ep_a2a":
                return moe_apply_ep_a2a(x, p, cfg, compute_dtype, mesh, data_axes, model_axis)
            return moe_apply_ep(x, p, cfg, compute_dtype, mesh, data_axes, model_axis)
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            return _dense_on_mesh(x, p, cfg, compute_dtype, mesh)
    return moe_apply_dense(x, p, cfg, compute_dtype)


def _dense_on_mesh(x, p, cfg, compute_dtype, mesh):
    """The dense path on a mesh whose model axis does not split the experts
    (one rank wide, or not dividing them): every token and every expert on
    every rank, the global computation that JAX's GSPMD partitions (its
    capacity from every token), as a ``shard_map`` over whole tensors.  On
    one rank it is the unsharded path's arithmetic."""
    def whole(t):
        return PSpec(*(None,) * t.ndim)

    banks = _banks(p)

    def body(xl, router, we_gate, we_up, we_down):
        lp = {"router": router, "we_gate": we_gate, "we_up": we_up, "we_down": we_down}
        return moe_apply_dense(xl, lp, cfg, compute_dtype)

    return shard_map(body, mesh, (whole(x), *(whole(b) for b in banks)), whole(x))(x, *banks)
