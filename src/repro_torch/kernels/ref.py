"""Plain PyTorch versions of the kernels: the ground truth each CUDA kernel
is held against on the card, and what the kernel wrappers run for tensors
on the CPU.  Counterpart of ``repro.kernels.ref`` (the two attention
oracles, the flash-attention backward, the row gather and the two scans),
with the same layouts and the same rounding points; and the plain versions
of the two fused scan kernels, which compute the JAX models' own
``selective_scan`` (``repro.models.ssm``) and ``rglru_scan``
(``repro.models.rglru``)."""

from __future__ import annotations

import torch

NEG_INF = -1e30
_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def _promote(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """JAX's promotion for the mixes the models make: an fp8 operand takes
    the other's type, otherwise the usual float promotion."""
    if a in _FP8:
        return b
    if b in _FP8:
        return a
    return torch.promote_types(a, b)


def flash_attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        return_lse: bool = False):
    """q [B, Sq, H, D]; k, v [B, Sk, KV, D] -> [B, Sq, H, D] in q's dtype
    (and the f32 log-sum-exp [B*H, Sq] of the masked, scaled scores when
    ``return_lse``)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    q5 = q.reshape(B, Sq, KV, G, D)
    # operands rounded to their own dtype, products and sums in f32
    # (JAX's preferred_element_type=f32)
    s = torch.einsum("bqkgd,bskd->bkgqs", q5.float(), k.float()) / (D**0.5)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    vt = v.to(_promote(q.dtype, v.dtype))
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(vt.dtype), vt).reshape(B, Sq, H, D)
    if not return_lse:
        return o
    lse = torch.logsumexp(s, dim=-1)  # [B, KV, G, Sq]
    return o, lse.reshape(B * H, Sq)


def flash_attention_bwd_ref(q, k, v, do, lse, delta, *, causal: bool = True,
                            q_offset: int = 0, group_sum: bool = True):
    """The flash-attention backward: q, do [B, Sq, H, D]; k, v [B, Sk, KV, D];
    lse, delta [B*H, Sq] f32 -> (dq [B, Sq, H, D], dk, dv).

    The rounding points are the TPU kernels': f32 scores times 1/sqrt(D),
    masked to NEG_INF, p = exp(s - lse), ds = p (dp - delta) / sqrt(D); P
    rounded to do's dtype for dV, dS to q's dtype for dK and to k's dtype
    for dQ; products and sums in f32.  dk, dv are [B, Sk, KV, D], each KV
    head's query group summed in f32 and rounded once to k's (v's) dtype, as
    the CUDA kernel does; with ``group_sum=False`` they are [B, Sk, H, D],
    each query head's rounded to k's dtype, as the TPU kernel emits them."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / (D**0.5)
    q5 = q.reshape(B, Sq, KV, G, D)
    do5 = do.reshape(B, Sq, KV, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", q5.float(), k.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, torch.full_like(s, NEG_INF))
    rows = lambda t: t.reshape(B, KV, G, Sq, 1)  # [B*H, Sq], h = kv * G + g
    p = torch.exp(s - rows(lse))
    dp = torch.einsum("bqkgd,bskd->bkgqs", do5.float(), v.float())
    ds = p * (dp - rows(delta)) * scale
    p_do = p.to(do.dtype).float()
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds.to(k.dtype).float(), k.float())
    dq = dq.reshape(B, Sq, H, D).to(q.dtype)
    dv = torch.einsum("bkgqs,bqkgd->bskgd", p_do, do5.float())
    dk = torch.einsum("bkgqs,bqkgd->bskgd", ds.to(q.dtype).float(), q5.float())
    if group_sum:
        return dq, dk.sum(3).to(k.dtype), dv.sum(3).to(v.dtype)
    return dq, dk.reshape(B, Sk, H, D).to(k.dtype), dv.reshape(B, Sk, H, D).to(v.dtype)


def decode_attention_ref(q, k, v, kv_len, with_lse: bool = False):
    """q [B, H, D]; k, v [B, S, KV, D]; kv_len a Python int, a 0-d or
    one-element int tensor, or a ``[B]`` int tensor (one length per batch
    row) -> [B, H, D]: one query row per head against the first ``kv_len``
    cache slots (of its row).  With ``with_lse`` also the f32 log-sum-exp
    [B, H] of the scaled, masked scores (-1e30 where no slot is live: every
    score is NEG_INF), the plain twin of the kernel's."""
    B, H, D = q.shape
    if isinstance(kv_len, torch.Tensor):
        # a length per row broadcasts as [B, 1, 1, 1], as JAX's oracle takes it
        kv_len = kv_len.reshape(()) if kv_len.numel() == 1 else kv_len.reshape(B, 1, 1, 1)
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    q5 = q.reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", q5.float(), k.float()) / (D**0.5)
    mask = torch.arange(S, device=q.device)[None, None, None, :] < kv_len
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    vt = v.to(_promote(q.dtype, v.dtype))
    o = torch.einsum("bkgs,bskd->bkgd", p.to(vt.dtype), vt).reshape(B, H, D)
    if not with_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(B, H)


def prefetch_gather_ref(table, idx):
    """table [N, D]; idx [B] -> [B, D]: rows ``idx`` of ``table``."""
    return torch.index_select(table, 0, idx)


def rglru_scan_ref(a, g, h0=None):
    """a, g [..., S, M] -> y [..., S, M] in a's dtype, with h_t = a_t *
    h_{t-1} + g_t and y_t = h_t in an f32 state starting from h0 [..., M]
    f32 (zeros when None): [S, M] as the JAX oracle takes it, [B, S, W] as
    the model passes it."""
    h = (torch.zeros(a.shape[:-2] + a.shape[-1:], dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(a.shape[-2]):
        h = a[..., t, :].float() * h + g[..., t, :].float()
        ys.append(h)
    if not ys:
        return torch.empty_like(a)
    return torch.stack(ys, dim=-2).to(a.dtype)


RGLRU_C = 8.0  # log a_t = -8 softplus(lam) r_t


def softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as ``logaddexp(x, 0)``, with no
    linear cut-off (``F.softplus`` returns x above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def rglru_decay(lam):
    """c = -8 softplus(lam) [W] f32, so that log a_t = c * r_t: the factor the
    fused RG-LRU kernel takes, formed with the plain version's own ops."""
    return -RGLRU_C * softplus(lam.float())


def rglru_gated_scan_ref(x, r, i, lam, h0=None):
    """The JAX model's ``rglru_scan``: x, r, i [B, S, W]; lam [W]; h0 [B, W]
    f32 or None -> (y [B, S, W] in x's dtype, h_S [B, W] f32), with a =
    exp(c r), g = f32(i x) sqrt(max(1 - a^2, 1e-12)) formed for the whole
    call in f32, then ``rglru_scan_ref`` over them; the decay and the gated
    input are f32, so the scan's f32 output at the last step is the final
    state exactly."""
    a = torch.exp(rglru_decay(lam) * r.float())
    gated = (i * x).float() * torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    ys = rglru_scan_ref(a, gated, h0)
    return ys.to(x.dtype), ys[:, -1]


def selective_scan_ref(u, dt, A, B_ssm, C_ssm, D, h0=None, h_out=None):
    """The JAX model's mamba-1 ``selective_scan``, one step at a time: u, dt
    [B, S, Ch]; A [Ch, N]; B_ssm, C_ssm [B, S, N]; D [Ch]; h0 [B, Ch, N] f32
    or None -> (y [B, S, Ch] in u's dtype, h_S [B, Ch, N] f32) with

        h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) outer B_t
        y_t = (h_t . C_t) + D * u_t

    dA_t and dBu_t formed per step, never for the whole sequence; dt * u
    rounded to the compute dtype first, as in JAX.  With ``h_out`` the last
    state is also written there (it may be ``h0``: the model's decode
    updates its cache in place) and returned."""
    Bsz, S, Ch = u.shape
    N = A.shape[1]
    Af = A.float()
    dtf = dt.float()
    dtu = (dt * u).float()
    Bf, Cf = B_ssm.float(), C_ssm.float()
    h = torch.zeros((Bsz, Ch, N), dtype=torch.float32, device=u.device) if h0 is None else h0
    steps = []
    for t in range(S):
        dA_t = torch.exp(dtf[:, t, :, None] * Af)  # [B, Ch, N]
        h = dA_t * h + dtu[:, t, :, None] * Bf[:, t, None, :]
        steps.append(torch.einsum("bcn,bn->bc", h, Cf[:, t]))
    ys = (torch.stack(steps, dim=1) if steps
          else torch.zeros((Bsz, 0, Ch), dtype=torch.float32, device=u.device))
    y = ys + D.float() * u.float()
    if h_out is not None:
        h = h_out.copy_(h)
    return y.to(u.dtype), h


def mamba_scan_ref(dA, dBu, C, h0=None, with_state: bool = False):
    """dA, dBu [..., S, Ch, N]; C [..., S, N] -> y [..., S, Ch] in dA's
    dtype, with h_t = dA_t * h_{t-1} + dBu_t and y_t = h_t . C_t in an f32
    state starting from h0 [..., Ch, N] f32 (zeros when None): [S, Ch, N] as
    the JAX oracle takes it, [B, S, Ch, N] as the model passes it.  With
    ``with_state`` also returns the last state [..., Ch, N] f32."""
    h = (torch.zeros(dA.shape[:-3] + dA.shape[-2:], dtype=torch.float32, device=dA.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(dA.shape[-3]):
        h = dA[..., t, :, :].float() * h + dBu[..., t, :, :].float()
        ys.append(torch.einsum("...cn,...n->...c", h, C[..., t, :].float()))
    y = (torch.stack(ys, dim=-2) if ys else dA.new_empty(dA.shape[:-1], dtype=torch.float32))
    y = y.to(dA.dtype)
    return (y, h) if with_state else y
