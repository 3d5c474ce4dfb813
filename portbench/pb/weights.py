"""The model's weights, made from the seed on the device in the type they
are served in (bf16), by the benchmark: the program and the plain reference
are handed the same tensors.

The tree is the parameter layout of the dense and moe families (stacked
``[L, ...]`` layers, the vocabulary padded to a multiple of 256 rows); the
run checks it against the program's own template before it hands it over.
A moe layer holds, in the MLP's place, the router ``[d, E]`` and the
expert banks ``we_gate``/``we_up`` ``[E, d, f]`` and ``we_down`` ``[E, f,
d]``.  Every leaf is normal: matrices of std 0.02 (the router and the
expert banks too; the embedding and the head 0.01), biases of std 0.02,
norm scales of mean 1 and std 0.05, so that no bias or scale is a no-op
that a fault could hide behind.
"""

from __future__ import annotations

import torch

CHUNK = 1 << 30  # elements per generator call


def vocab_rows(cfg: dict) -> int:
    return -(-cfg["vocab_size"] // 256) * 256


def layout(cfg: dict) -> dict:
    """{dotted path: (shape, mean, std)} of every leaf."""
    d, L, V = cfg["d_model"], cfg["n_layers"], vocab_rows(cfg)
    qd, kvd, hd = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"], cfg["head_dim"]
    mat, norm = (0.0, 0.02), (1.0, 0.05)
    out = {
        "embed": ((V, d), 0.0, 0.01),
        "lm_head": ((d, V), 0.0, 0.01),
        "final_norm": ((d,), *norm),
        "layers.ln1": ((L, d), *norm),
        "layers.ln2": ((L, d), *norm),
        "layers.attn.wq": ((L, d, qd), *mat),
        "layers.attn.wk": ((L, d, kvd), *mat),
        "layers.attn.wv": ((L, d, kvd), *mat),
        "layers.attn.wo": ((L, qd, d), *mat),
    }
    if cfg["qkv_bias"]:
        out.update({"layers.attn.bq": ((L, qd), *mat), "layers.attn.bk": ((L, kvd), *mat),
                    "layers.attn.bv": ((L, kvd), *mat)})
    if cfg["qk_norm"]:
        out.update({"layers.attn.q_norm": ((L, hd), *norm), "layers.attn.k_norm": ((L, hd), *norm)})
    f = cfg["d_ff"]
    if cfg["family"] == "moe":
        E = cfg["n_experts"]
        out.update({"layers.mlp.router": ((L, d, E), *mat), "layers.mlp.we_gate": ((L, E, d, f), *mat),
                    "layers.mlp.we_up": ((L, E, d, f), *mat), "layers.mlp.we_down": ((L, E, f, d), *mat)})
    else:
        out.update({"layers.mlp.wi_gate": ((L, d, f), *mat), "layers.mlp.wi_up": ((L, d, f), *mat),
                    "layers.mlp.wo": ((L, f, d), *mat)})
    return out


def make(cfg: dict, seed: int, device) -> dict:
    """The nested tree of bf16 leaves from a generator on ``device`` seeded
    with ``seed``, leaf after leaf in sorted path order, each filled in
    calls of up to ``CHUNK`` elements."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    tree: dict = {}
    for path, (shape, mean, std) in sorted(layout(cfg).items()):
        t = torch.empty(shape, dtype=torch.bfloat16, device=device)
        flat = t.view(-1)
        for a in range(0, flat.numel(), CHUNK):
            flat[a:a + CHUNK].normal_(mean, std, generator=gen)
        node = tree
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def leaves(tree: dict, prefix: str = ""):
    """(dotted path, tensor) of every leaf of a nested tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v
