"""The plain reference: the forward pass of the dense and moe families in
plain PyTorch and float32 (TF32 off), written from the configuration file
and importing nothing of the program.

It reads the benchmark's bf16 weights (``weights.py``), widened to f32 on
use, one layer at a time (an expert bank one expert at a time), so that it
fits beside the served model.  What it computes, from the configuration's
keys:

- RMSNorm with ``norm_eps``; q, k, v projections (``qkv_bias``), a per-head
  RMSNorm of q and k (``qk_norm``); rotary embeddings on the first
  ``head_dim`` (``rope: "default"``) or ``head_dim / 2`` (``"half"``) dims of
  each head, the dims split into two halves that rotate together, with
  frequencies ``rope_theta ** (-2 i / rotated)``; causal grouped-query
  attention (query head h reads kv head h // (n_heads / n_kv_heads));
- a SwiGLU MLP (``family: "dense"``), or (``"moe"``) the routed experts as
  the published Qwen3-MoE routes them (``norm_topk_prob``): router logits
  in f32, a softmax over all ``n_experts``, the top ``experts_per_token``
  kept and renormalised to sum to 1, each chosen expert's SwiGLU weighted
  by its gate and summed.  No capacity and no drop: every token reaches
  each expert it chose, whatever the others chose.  The program's
  ``capacity_factor`` and ``moe_chunk`` are not read: they are its
  dispatch, and a configuration whose capacity can drop a pair departs
  from this reference there (``capacity_factor`` at ``n_experts /
  experts_per_token`` gives a capacity equal to the chunk, which drops
  nothing);
- the final norm and the untied head over the first ``vocab_size`` columns.

``prec="fp8"`` is the control: every matrix product but the router's takes
its weight rounded to fp8 e4m3 with one scale per output column (per
expert for a bank) and its input rounded with one scale per row (W8A8),
accumulating in f32; the router's product stays in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def exact_f32() -> None:
    """f32 products in f32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` (f32) rounded to fp8 e4m3 with one scale per slice along
    ``dim``'s complement (the scale maps each slice's largest magnitude to
    448), back in f32."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    def __init__(self, cfg: dict, tree: dict, prec: str = "f32"):
        if prec not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {prec!r}")
        if (cfg["norm"], cfg["mlp"]) != ("rmsnorm", "swiglu") or cfg["family"] not in ("dense", "moe"):
            raise NotImplementedError(f"no reference for {cfg['name']}: {cfg['family']}, "
                                      f"{cfg['norm']}, {cfg['mlp']}")
        self.cfg, self.tree, self.prec = cfg, tree, prec
        self.eps = cfg["norm_eps"]
        self._layer = None
        self._head = None

    # -- weights -------------------------------------------------------------

    def _weight(self, w: torch.Tensor) -> torch.Tensor:
        """A [..., in, out] matrix widened to f32 (fp8-rounded per output
        column in the control)."""
        w = w.float()
        return fp8_round(w, dim=-2) if self.prec == "fp8" else w

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.prec == "fp8":
            x = fp8_round(x, dim=-1)
        return x @ w

    def layer(self, l: int) -> dict:
        """Layer ``l``'s weights in f32, but for the expert banks
        (``expert``)."""
        if self._layer is not None and self._layer[0] == l:
            return self._layer[1]
        lw = {}
        for name, t in self.tree["layers"].items():
            if not isinstance(t, dict):  # ln1, ln2
                lw[name] = t[l].float()
                continue
            for sub, w in t.items():
                if sub.startswith("we_"):
                    continue
                if sub.startswith("w"):
                    lw[f"{name}.{sub}"] = self._weight(w[l])
                else:  # biases, norm scales and the router: f32 as they are
                    lw[f"{name}.{sub}"] = w[l].float()
        self._layer = (l, lw)
        return lw

    def expert(self, l: int, e: int) -> tuple:
        """Expert ``e`` of layer ``l``: its gate, up and down matrices."""
        bank = self.tree["layers"]["mlp"]
        return tuple(self._weight(bank[n][l, e]) for n in ("we_gate", "we_up", "we_down"))

    def head(self) -> torch.Tensor:
        if self._head is None:
            self._head = self._weight(self.tree["lm_head"][:, : self.cfg["vocab_size"]])
        return self._head

    # -- pieces ---------------------------------------------------------------

    def norm(self, x, scale):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) * scale

    def rope(self, x, pos):
        """x [T, heads, hd] at positions pos [T]."""
        cfg = self.cfg
        hd = cfg["head_dim"]
        rot = {"default": hd, "half": hd // 2}[cfg["rope"]]
        inv = cfg["rope_theta"] ** (-torch.arange(0, rot, 2, dtype=torch.float64, device=x.device) / rot)
        ang = (pos.double()[:, None] * inv).float()[:, None, :]  # [T, 1, rot/2]
        cos, sin = torch.cos(ang), torch.sin(ang)
        a, b, rest = x[..., : rot // 2], x[..., rot // 2: rot], x[..., rot:]
        return torch.cat([a * cos - b * sin, b * cos + a * sin, rest], dim=-1)

    def qkv(self, h, lw, pos):
        cfg = self.cfg
        H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
        q, k, v = (self._mm(h, lw[f"attn.w{n}"]) for n in "qkv")
        if cfg["qkv_bias"]:
            q, k, v = q + lw["attn.bq"], k + lw["attn.bk"], v + lw["attn.bv"]
        q, k, v = q.view(-1, H, hd), k.view(-1, KV, hd), v.view(-1, KV, hd)
        if cfg["qk_norm"]:
            q, k = self.norm(q, lw["attn.q_norm"]), self.norm(k, lw["attn.k_norm"])
        return self.rope(q, pos), self.rope(k, pos), v

    def attend(self, q, k, v, causal_from: int, block: int = 512):
        """q [Tq, H, hd] over k, v [Tk, KV, hd]; query i sits at key
        position causal_from + i and sees the keys up to it.  Queries go in
        blocks of ``block``, so that the scores of a long prompt fit."""
        cfg = self.cfg
        G = cfg["n_heads"] // cfg["n_kv_heads"]
        k, v = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
        kpos = torch.arange(k.shape[0], device=q.device)[None, :]
        out = []
        for a in range(0, q.shape[0], block):
            qb = q[a:a + block]
            s = torch.einsum("qhd,khd->hqk", qb, k) / cfg["head_dim"] ** 0.5
            qpos = causal_from + a + torch.arange(qb.shape[0], device=q.device)[:, None]
            s = s.masked_fill(kpos > qpos, float("-inf"))
            out.append(torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v))
        return torch.cat(out)

    def swiglu(self, h, gate, up, down):
        return self._mm(F.silu(self._mm(h, gate)) * self._mm(h, up), down)

    def mlp(self, h, lw, l: int):
        if self.cfg["family"] == "dense":
            return self.swiglu(h, lw["mlp.wi_gate"], lw["mlp.wi_up"], lw["mlp.wo"])
        return self.moe(h, lw, l)

    def moe(self, h, lw, l: int):
        """The routed experts over the tokens h [T, d], expert by expert:
        each expert's rows gathered, its SwiGLU, and the rows added back
        weighted by their gates."""
        k = self.cfg["experts_per_token"]
        probs = torch.softmax(h @ lw["mlp.router"], dim=-1)
        gate, chosen = torch.topk(probs, k, dim=-1)
        gate = gate / gate.sum(-1, keepdim=True)
        out = torch.zeros_like(h)
        for e in range(self.cfg["n_experts"]):
            rows, j = torch.where(chosen == e)
            if rows.numel():
                y = self.swiglu(h[rows], *self.expert(l, e))
                out.index_add_(0, rows, y * gate[rows, j, None])
        return out

    def logits(self, h):
        """The head over the final norm's output h [T, d]."""
        return self._mm(h, self.head())

    # -- passes ----------------------------------------------------------------

    def forward(self, seqs: list, hidden_from: list):
        """Full causal forward passes over ``seqs`` (1-d token tensors), layer
        by layer, the MLP (or the experts) over every sequence's tokens at
        once.  Returns, per sequence, (the final norm's output [S -
        hidden_from, d] at positions hidden_from .. S - 1, k and v [L, S,
        KV, hd] as the cache holds them: after the norm and the
        rotation)."""
        xs = [self.tree["embed"][s].float() for s in seqs]
        pos = [torch.arange(len(s), device=s.device) for s in seqs]
        ks = [[] for _ in seqs]
        vs = [[] for _ in seqs]
        for l in range(self.cfg["n_layers"]):
            lw = self.layer(l)
            for i, x in enumerate(xs):
                q, k, v = self.qkv(self.norm(x, lw["ln1"]), lw, pos[i])
                o = self.attend(q, k, v, 0).reshape(x.shape[0], -1)
                xs[i] = x + self._mm(o, lw["attn.wo"])
                ks[i].append(k)
                vs[i].append(v)
            x = torch.cat(xs)
            x = x + self.mlp(self.norm(x, lw["ln2"]), lw, l)
            xs = list(x.split([len(s) for s in seqs]))
        final = self.tree["final_norm"].float()
        return [(self.norm(x[f:], final), torch.stack(k), torch.stack(v))
                for x, f, k, v in zip(xs, hidden_from, ks, vs)]
