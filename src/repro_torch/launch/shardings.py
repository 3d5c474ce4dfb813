"""Logical-axis sharding rules per (config x shape kind x mesh), and their
DTensor placements.  Counterpart of ``repro.launch.shardings``; the rules
are JAX's, entry for entry.

The parallelism recipe:

  * ``train`` / ``prefill``: DP over (pod, data); Megatron-style TP over
    ``model`` (attention head dims, MLP hidden, vocab/embedding); EP for MoE
    experts over ``model`` (a ``local_map`` with a sum over ``model``);
    sequence stays unsharded unless ``sequence_parallel``.
  * ``decode``: batch over (pod, data); the KV cache is sequence-sharded
    over ``model``.
  * ``long`` (batch=1 decode): no batch to shard; recurrent/conv states and
    window caches are sharded over every axis (data and model).

A spec is a ``PSpec``: a tuple with one entry per tensor dim, each None, a
mesh-axis name, or a tuple of names (the dim split over those axes, the
first outermost), as JAX's ``PartitionSpec``.  ``placements`` maps it to
the ``Shard``/``Replicate`` placement of each mesh dim.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig

from .mesh import axis_sizes, data_axes, entry_axes


class PSpec(tuple):
    """A partition spec: one entry per tensor dim (None, an axis name, or a
    tuple of axis names)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PSpec{tuple.__repr__(self)}"


def _mesh_size(sizes: dict) -> int:
    n = 1
    for s in sizes.values():
        n *= s
    return n


def logical_rules(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    sizes = axis_sizes(mesh)
    dp = data_axes(mesh)
    dp_entry = dp if len(dp) > 1 else dp[0]
    n_model = sizes["model"]
    long_ctx = shape.kind == "decode" and shape.global_batch < sizes[dp[0]]

    if cfg.parallelism == "fsdp" and shape.kind in ("train", "prefill"):
        return _fsdp_rules(cfg, shape, mesh, dp)
    if cfg.parallelism == "fsdp_ep" and shape.kind in ("train", "prefill"):
        # MoE hybrid: experts stay expert-parallel over `model`; dense
        # weights fully sharded; batch over data only, so that the EP sum
        # over `model` applies
        rules = _fsdp_rules(cfg, shape, mesh, dp)
        rules["batch"] = dp if len(dp) > 1 else dp[0]
        rules["experts"] = "model"
        return rules
    if cfg.parallelism == "ep_a2a" and shape.kind in ("train", "prefill"):
        # full EP: tokens sharded over every axis, all-to-all token exchange
        rules = _fsdp_rules(cfg, shape, mesh, dp)
        rules["experts"] = "model"
        return rules

    seq_rule = None
    if (
        cfg.sequence_parallel
        and shape.kind in ("train", "prefill")
        and shape.seq_len % n_model == 0
    ):
        seq_rule = "model"  # sequence parallelism (Megatron SP)
    rules = {
        "batch": dp_entry,
        "seq": seq_rule,
        "embed": None,
        "layers": None,
        # weight dims (flattened head dims: always divisible)
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        # activation dims (only when they divide the axis)
        "act_heads": "model" if cfg.n_heads % n_model == 0 else None,
        "act_kv": "model" if cfg.n_kv_heads % n_model == 0 else None,
        "act_ff": "model",
        "act_vocab": "model",
        "inner_seq": None,
        # decode cache axes
        "cache_seq": "model" if shape.kind == "decode" else None,
        "state": None,
    }
    if long_ctx:
        # batch=1: spread states/caches over everything available
        rules["batch"] = None
        rules["ff"] = dp + ("model",)
        rules["cache_seq"] = dp_entry
        rules["act_heads"] = None
        rules["act_kv"] = None
    return rules


def _fsdp_rules(cfg: ModelConfig, shape: ShapeConfig, mesh, dp: tuple) -> dict:
    """Fully-sharded data parallelism: the batch spreads over every mesh
    axis; weight matrices shard over (data..., model) on their wide dims and
    are gathered per layer.  Falls back to model-only sharding on dims that
    the full axis product does not divide."""
    sizes = axis_sizes(mesh)
    all_axes = dp + ("model",)
    n_all = _mesh_size(sizes)

    def wide(dim_size: int):
        if dim_size % n_all == 0:
            return all_axes
        return "model" if dim_size % sizes["model"] == 0 else None

    from repro_torch.models.model import padded_vocab

    batch_ok = shape.global_batch % n_all == 0
    return {
        "batch": all_axes if batch_ok else (dp if len(dp) > 1 else dp[0]),
        "seq": None,
        "embed": None,
        "layers": None,
        "heads": wide(cfg.q_dim),
        "kv_heads": wide(cfg.kv_dim),
        "ff": wide(max(cfg.d_ff, cfg.d_inner if cfg.family == "ssm" else 0,
                       cfg.lru_width if cfg.family == "hybrid" else 0) or 1),
        "vocab": wide(padded_vocab(cfg)),
        "experts": "model",
        "act_heads": None,
        "act_kv": None,
        "act_ff": None,
        "act_vocab": None,
        "inner_seq": None,
        "cache_seq": None,
        "state": None,
    }


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """Specs of the input batch (follows the 'batch' rule)."""
    dp_entry = logical_rules(cfg, shape, mesh)["batch"]
    specs = {"inputs": PSpec(dp_entry, None)}
    if shape.kind == "train":
        specs["targets"] = PSpec(dp_entry, None)
    if cfg.embeds_input:
        specs["embeds"] = PSpec(dp_entry, None, None)
        if cfg.rope == "mrope":
            specs["positions"] = PSpec(None, dp_entry, None)
    if cfg.family == "encdec":
        specs["frames"] = PSpec(dp_entry, None, None)
    return specs


def off_batch(rules: dict, name: str):
    """The mesh axes of rule ``name`` that the batch rule does not take, as
    a spec entry (an axis, a tuple of them, or None): what an activation
    split over the batch can also be split over on that dim."""
    batch = set(entry_axes(rules.get("batch")))
    axes = tuple(a for a in entry_axes(rules.get(name)) if a not in batch)
    return axes[0] if len(axes) == 1 else (axes or None)


def cache_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """Specs of the decode cache (``Model.abstract_cache``'s tree).

    Where ``cache_seq`` and ``act_kv`` name the same axis (decode, with
    ``model`` dividing the kv heads), the sequence keeps it and the kv heads
    go whole, in the self-attention cache and in encdec's cross k/v alike.
    JAX's ``cache_pspecs`` names the axis twice there, a spec its
    ``NamedSharding`` refuses (``DuplicateSpecError``); the layout kept here
    is the one JAX's production meshes give, whose 16-wide ``model`` divides
    no config's kv heads."""
    rules = logical_rules(cfg, shape, mesh)
    b = rules["batch"]
    cseq = rules["cache_seq"]
    kvh = rules["act_kv"]
    if set(entry_axes(kvh)) & set(entry_axes(cseq)):
        kvh = None
    ff = rules["ff"]
    if cfg.family in ("dense", "moe"):
        kv = PSpec(None, b, cseq, kvh, None)
        return {"k": kv, "v": kv}
    if cfg.family == "ssm":
        return {"conv": PSpec(None, b, None, ff), "ssm": PSpec(None, b, ff, None)}
    if cfg.family == "hybrid":
        return {
            "conv": PSpec(None, b, None, ff),
            "rec": PSpec(None, b, ff),
            "k": PSpec(None, b, cseq, kvh, None),
            "v": PSpec(None, b, cseq, kvh, None),
        }
    if cfg.family == "encdec":
        kv = PSpec(None, b, cseq, kvh, None)
        ckv = PSpec(None, b, None, kvh, None)
        return {"k": kv, "v": kv, "cross_k": ckv, "cross_v": ckv}
    raise ValueError(cfg.family)


def placements(mesh, spec) -> tuple:
    """The DTensor placement of each mesh dim for ``spec``: ``Shard(d)``
    where tensor dim ``d``'s entry names the axis, else ``Replicate()``.
    A dim split over several axes must name them in mesh order (outermost
    first), which is how DTensor nests them.  An axis that names two dims
    raises, as JAX's ``NamedSharding`` does (``DuplicateSpecError``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not in mesh order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} names two tensor dims "
                                 f"({out[i].dim} and {d})")
            out[i] = Shard(d)
    return tuple(out)


def named(mesh, spec_tree, tree):
    """``tree`` (a nested dict of tensors, each whole on every rank)
    distributed by ``spec_tree``: each leaf a DTensor holding a copy of this
    rank's shard; a leaf that already is a DTensor stays as it is.
    Counterpart of placing a tree with JAX's ``NamedSharding``s."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(tree, dict):
        return {k: named(mesh, spec_tree[k], v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        return tree
    return distribute_tensor(tree, mesh, placements(mesh, spec_tree), src_data_rank=None)
