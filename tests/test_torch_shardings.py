"""The port's sharding rules against the JAX package's, with no processes:
``logical_rules``, ``batch_pspecs``, ``cache_pspecs`` and
``Model.param_pspecs``, entry for entry, for every architecture, every
shape, both parallelisms (plus ``fsdp_ep`` and ``ep_a2a`` for the MoE
configs) and the 16x16, 2x16x16 and 2x4 meshes, on a shape-only mesh; the
port's twin of ``test_property_invariants.py``'s divisibility check; the
placements a spec maps to."""

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import shardings as jshard
from repro.models.model import Model as JModel
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import shardings
from repro_torch.launch.mesh import data_axes
from repro_torch.models.common import tree_items
from repro_torch.models.model import Model

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x4": {"data": 2, "model": 4},
}
MOE = ("qwen3_moe_30b_a3b", "granite_moe_1b_a400m")
CASES = [(a, p) for a in ARCH_IDS for p in ("tp", "fsdp")] + [
    (a, p) for a in MOE for p in ("fsdp_ep", "ep_a2a")]


class _FakeMesh:
    """Shape-only stand-in (no devices needed for the rules)."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = int(np.prod(list(shape.values())))


def _shapes(cfg):
    return [s for s in SHAPES.values()
            if not (s.name == "long_500k" and cfg.family not in ("ssm", "hybrid"))]


def _jspec_items(tree, prefix=""):
    """(dotted path, spec as a tuple) of a JAX tree of PartitionSpecs, keys
    sorted (the order of ``tree_items``)."""
    for k in sorted(tree):
        path = f"{prefix}.{k}" if prefix else k
        v = tree[k]
        if isinstance(v, dict):
            yield from _jspec_items(v, path)
        else:
            yield path, tuple(v)


def _same(port_tree, jax_tree, what):
    got = [(p, tuple(s)) for p, s in tree_items(port_tree)]
    want = list(_jspec_items(jax_tree))
    assert got == want, what


def _names(entry) -> set:
    if entry is None:
        return set()
    return set(entry) if isinstance(entry, tuple) else {entry}


def _repaired(jcache: dict) -> dict:
    """JAX's cache specs as tuples, with the port's repair of the
    reference's fault: where the self cache's sequence (dim 2) and kv heads
    (dim 3) name one mesh axis, which JAX's ``NamedSharding`` refuses, the
    kv heads go whole in every k/v of the cache (cross k/v included)."""
    out = {k: tuple(v) for k, v in jcache.items()}
    if "k" in out and _names(out["k"][2]) & _names(out["k"][3]):
        for key in ("k", "v", "cross_k", "cross_v"):
            if key in out:
                out[key] = out[key][:3] + (None,) + out[key][4:]
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,parallelism", CASES)
def test_rules_and_specs_equal_jax(arch, parallelism, mesh_name):
    mesh = _FakeMesh(MESHES[mesh_name])
    cfg = get_config(arch).replace(parallelism=parallelism)
    jcfg = jget_config(arch).replace(parallelism=parallelism)
    model, jmodel = Model(cfg, device="cpu"), JModel(jcfg)
    for shape in _shapes(cfg):
        jshape = JSHAPES[shape.name]
        what = (arch, parallelism, mesh_name, shape.name)
        rules = shardings.logical_rules(cfg, shape, mesh)
        jrules = jshard.logical_rules(jcfg, jshape, mesh)
        assert rules == jrules, what
        bs = shardings.batch_pspecs(cfg, shape, mesh)
        jbs = jshard.batch_pspecs(jcfg, jshape, mesh)
        assert {k: tuple(v) for k, v in bs.items()} == {k: tuple(v) for k, v in jbs.items()}, what
        if shape.kind == "decode":
            cs = shardings.cache_pspecs(cfg, shape, mesh)
            jcs = _repaired(jshard.cache_pspecs(jcfg, jshape, mesh))
            assert {k: tuple(v) for k, v in cs.items()} == jcs, what
        _same(model.param_pspecs(rules), jmodel.param_pspecs(jrules), what)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,parallelism", CASES)
def test_param_shardings_divide_exactly(arch, parallelism, mesh_name):
    """Every parameter's spec divides its dims (the port's twin of
    ``test_property_invariants.py::test_param_shardings_divide_exactly``,
    over the 2x4 mesh and the MoE layouts too)."""
    mesh = _FakeMesh(MESHES[mesh_name])
    cfg = get_config(arch).replace(parallelism=parallelism)
    model = Model(cfg, device="cpu")
    abstract = dict(tree_items(model.abstract_params()))
    for shape in _shapes(cfg):
        rules = shardings.logical_rules(cfg, shape, mesh)
        for path, spec in tree_items(model.param_pspecs(rules)):
            dims = abstract[path].shape
            assert len(spec) == len(dims), (path, spec)
            for dim, entry in zip(dims, spec):
                if entry is None:
                    continue
                axes = entry if isinstance(entry, tuple) else (entry,)
                n = int(np.prod([mesh.shape[a] for a in axes]))
                assert dim % n == 0, (arch, parallelism, shape.name, path, dim, spec)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _FakeMesh(MESHES["2x16x16"])
    P = shardings.PSpec
    assert data_axes(mesh) == ("pod", "data")
    assert shardings.placements(mesh, P(None, "model")) == (Replicate(), Replicate(), Shard(1))
    assert shardings.placements(mesh, P(("pod", "data"), None)) == (Shard(0), Shard(0),
                                                                    Replicate())
    assert shardings.placements(mesh, P(("pod", "data", "model"),)) == (Shard(0),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        shardings.placements(mesh, P(("model", "data"), None))
    assert repr(P("data", None)) == "PSpec('data', None)"


def test_placements_refuse_an_axis_named_twice_as_jax_does():
    """JAX's decode cache spec for chatglm3's smoke config on a 2x2 mesh
    names ``model`` twice (its sequence and its 2 kv heads): JAX's
    ``NamedSharding`` raises ``DuplicateSpecError``, and ``placements``
    raises on the same spec (it would otherwise shard one dim and drop the
    other in silence)."""
    from jax.sharding import AbstractMesh, NamedSharding
    from jax.sharding import PartitionSpec as JP

    jmesh = AbstractMesh((2, 2), ("data", "model"))
    jcfg = jget_config("chatglm3_6b")
    jspec = jshard.cache_pspecs(jcfg, JSHAPES["decode_32k"], jmesh)["k"]
    assert tuple(jspec) == (None, "data", "model", "model", None)
    with pytest.raises(Exception, match="duplicate") as err:
        NamedSharding(jmesh, jspec)
    assert type(err.value).__name__ == "DuplicateSpecError"
    mesh = _FakeMesh({"data": 2, "model": 2})
    with pytest.raises(ValueError, match="names two tensor dims"):
        shardings.placements(mesh, shardings.PSpec(*jspec))
    with pytest.raises(ValueError, match="names two tensor dims"):
        shardings.placements(mesh, shardings.PSpec(("data", "model"), "model"))
    NamedSharding(jmesh, JP(None, "data", "model", None, None))  # the port's layout


@pytest.mark.parametrize("arch", ["chatglm3_6b", "qwen3_moe_30b_a3b"])
def test_decode_cache_keeps_the_sequence_on_model(arch):
    """The port's decode cache on a 2x2 mesh, smoke and full configs: the
    sequence over ``model``, the kv heads whole (both configs' kv heads
    divide ``model``); on the production 16x16 mesh, JAX's spec unchanged."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig

    mesh = _FakeMesh({"data": 2, "model": 2})
    for cfg in (get_smoke_config(arch), get_config(arch)):
        specs = shardings.cache_pspecs(cfg, ShapeConfig("d", "decode", 256, 8), mesh)
        assert specs == {"k": shardings.PSpec(None, "data", "model", None, None),
                         "v": shardings.PSpec(None, "data", "model", None, None)}
        for spec in specs.values():
            shardings.placements(mesh, spec)
    big = _FakeMesh(MESHES["16x16"])
    cs = shardings.cache_pspecs(get_config(arch), SHAPES["decode_32k"], big)
    jcs = jshard.cache_pspecs(jget_config(arch), JSHAPES["decode_32k"], big)
    assert {k: tuple(v) for k, v in cs.items()} == {k: tuple(v) for k, v in jcs.items()}


@pytest.mark.parametrize("mesh_name", list(MESHES) + ["2x2"])
@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "recurrentgemma_2b", "whisper_large_v3"])
def test_recurrent_and_encdec_cache_specs_equal_jax(arch, mesh_name):
    """The decode cache specs of the ssm, hybrid and encdec families,
    smoke and full configs, entry for entry against JAX's (with the port's
    repair where the sequence and the kv heads name one axis: kv heads
    whole, in the cross k/v too): at a ``decode_32k``-like batch, and for
    ssm and hybrid at batch 1, the ``long`` layout (``ff`` over every axis,
    the ring's sequence over the data axes, nothing over the batch).  Each
    spec maps to placements; a dim split over several axes is a ``Shard``
    of that dim on each, in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    from repro.configs import get_smoke_config as jget_smoke
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig

    mesh = _FakeMesh(MESHES.get(mesh_name, {"data": 2, "model": 2}))
    names = list(mesh.shape)
    for cfg, jcfg in ((get_config(arch), jget_config(arch)),
                      (get_smoke_config(arch), jget_smoke(arch))):
        shapes = [ShapeConfig("d", "decode", 32_768, 128)]
        if cfg.family in ("ssm", "hybrid"):
            shapes.append(ShapeConfig("d", "decode", 524_288, 1))
        for shape in shapes:
            what = (arch, cfg.name, mesh_name, shape.global_batch)
            cs = shardings.cache_pspecs(cfg, shape, mesh)
            jcs = _repaired(jshard.cache_pspecs(jcfg, shape, mesh))
            assert {k: tuple(v) for k, v in cs.items()} == jcs, what
            dp = data_axes(mesh)
            if shape.global_batch == 1:
                assert cs["conv"][3] == dp + ("model",) and cs["conv"][1] is None, what
                if "k" in cs:
                    assert cs["k"][2] == (dp if len(dp) > 1 else dp[0]), what
            if cfg.family == "encdec":
                assert cs["cross_k"][2] is None and cs["cross_k"][1] == cs["k"][1], what
            for spec in cs.values():
                pl = shardings.placements(mesh, spec)
                for d, entry in enumerate(spec):
                    for a in _names(entry):
                        assert pl[names.index(a)] == Shard(d), what
                assert sum(p != Replicate() for p in pl) == sum(len(_names(e)) for e in spec)
