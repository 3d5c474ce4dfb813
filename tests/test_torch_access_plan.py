"""The port's CAPre access plan (``repro_torch.core.access_plan``, traced on
the ``meta`` device) against the JAX package's (traced with
``jax.make_jaxpr``), on the CPU.

Twins of tests/test_access_plan.py:34-97 (a toy loop over stacked
parameters, ``torch.cond`` for ``lax.cond``, a real decode plan, the ROP
plan), then parity: for the four dense, the two moe, the ssm and the hybrid
smoke configs and for chatglm3-6b, qwen3-moe-30b-a3b and falcon-mamba-7b
at full size,
``Server.plan`` of both packages has the same records (path, shape, bytes,
collection and branch flags) and the same groups (records of equal first
use) in the same order.  ``first_use`` values and ``uses``
differ by construction (the port counts aten nodes and a use per layer, JAX
counts equations and one scan), so parity leaves them out.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)  # beside the other test workers on the CPU

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.core.access_plan import build_access_plan as jbuild_access_plan
from repro.core.access_plan import rop_plan as jrop_plan
from repro.launch.serve import Server as JServer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.access_plan import build_access_plan, rop_plan
from repro_torch.launch.serve import Server
from repro_torch.models.model import Model

DENSE = ["chatglm3_6b", "yi_34b", "qwen1_5_4b", "minitron_8b"]


def _toy_params():
    return {
        "embed": torch.ones((32, 8)),
        "layers": {"w": torch.ones((4, 8, 8)), "b": torch.ones((4, 8))},
        "head": torch.ones((8, 32)),
        "unused": torch.ones((16,)),
    }


def _toy_step(params, x):
    h = params["embed"][x]
    for l in range(params["layers"]["w"].shape[0]):  # the port's layer loop
        lp = {k: v[l] for k, v in params["layers"].items()}
        h = torch.tanh(h @ lp["w"] + lp["b"])
    return h @ params["head"]


def test_plan_detects_loop_collections_and_order():
    plan = build_access_plan(_toy_step, _toy_params(), torch.zeros((4,), dtype=torch.int64))
    by_path = {r.path: r for r in plan.records}
    # stacked layers consumed layer by layer are collections (CAPre: the
    # loop accesses all elements -> prefetch the whole collection)
    assert by_path["layers.w"].collection
    assert by_path["layers.b"].collection
    assert not by_path["embed"].collection
    # program order: embed before layers before head
    assert by_path["embed"].first_use < by_path["layers.w"].first_use < by_path["head"].first_use
    # one loop entry: the layer selects of a layer share one tick
    assert by_path["layers.w"].first_use == by_path["layers.b"].first_use
    assert by_path["layers.w"].uses == 8  # per layer: the select and the product
    # unused params never appear (no false positives — unlike ROP)
    assert "unused" not in by_path
    assert by_path["layers.w"].shape == (4, 8, 8) and by_path["layers.w"].nbytes == 4 * 64 * 4


def _cond_step(params, x, flag):
    def t_branch(p, x):
        return x @ p["wa"] + x @ p["wc"]

    def f_branch(p, x):
        return x @ p["wb"] + x @ p["wc"]

    return torch.cond(flag, t_branch, f_branch, (params, x))


def _jax_cond_step(params, x, flag):
    def t_branch(p, x):
        return x @ p["wa"] + x @ p["wc"]

    def f_branch(p, x):
        return x @ p["wb"] + x @ p["wc"]

    return jax.lax.cond(flag, t_branch, f_branch, params, x)


def test_plan_marks_branch_dependent_cond():
    """torch.cond branches = the paper's branch-dependent navigations:
    params used in only one branch are marked; params used in both are not,
    as JAX marks them under lax.cond."""
    params = {"wa": torch.ones((4, 4)), "wb": torch.ones((4, 4)), "wc": torch.ones((4, 4))}
    plan = build_access_plan(_cond_step, params, torch.ones((2, 4)), torch.tensor(True))
    by_path = {r.path: r for r in plan.records}
    assert by_path["wa"].branch_dependent
    assert by_path["wb"].branch_dependent
    # union-of-branches promotion: wc is used in every branch
    assert not by_path["wc"].branch_dependent

    jparams = {k: jnp.ones((4, 4)) for k in params}
    jplan = jbuild_access_plan(_jax_cond_step, jparams, jnp.ones((2, 4)), jnp.array(True))
    assert _records(plan) == _records(jplan)


def test_plan_on_real_model_decode():
    """The decode step of a real (reduced) architecture yields a plan whose
    collections are the stacked layer parameters."""
    model = Model(get_smoke_config("chatglm3_6b"), device="cpu")
    plan = build_access_plan(
        lambda p, c, t: model.decode_step(p, c, t, 8),
        model.abstract_params(),  # no allocation — compile-time analysis
        model.abstract_cache(2, 16),
        torch.empty((2, 1), dtype=torch.int64, device="meta"),
    )
    colls = {r.path for r in plan.collections()}
    assert any(p.startswith("layers.attn") for p in colls)
    by_path = {r.path: r for r in plan.records}
    assert by_path["embed"].first_use < by_path["final_norm"].first_use


def test_rop_plan_never_includes_collections_usefully():
    params = _toy_params()
    rp = rop_plan(params, depth_groups=2)
    # ROP takes the first groups in schema order, blind to the program:
    # it cannot know the loop consumes all layers
    assert all(not r.collection for r in rp.records)
    # the schema order is JAX's sorted one
    jparams = jax.tree.map(lambda t: jnp.ones(tuple(t.shape)), params)
    jrp = jrop_plan(jparams, depth_groups=2)
    assert [(r.path, r.first_use, r.nbytes, r.shape) for r in rp.records] == \
        [(r.path, r.first_use, r.nbytes, r.shape) for r in jrp.records]
    assert [r.path for r in rp.records] == ["embed", "head"]


def _records(plan) -> dict:
    return {r.path: (tuple(r.shape), r.nbytes, r.collection, r.branch_dependent)
            for r in plan.records}


def _groups(plan) -> list[set]:
    """Records of equal first use, in first-use order (the streamer's
    groups)."""
    out, last = [], None
    for r in plan.ordered():
        if out and r.first_use == last:
            out[-1].add(r.path)
        else:
            out.append({r.path})
        last = r.first_use
    return out


def _assert_same_plan(plan, jplan):
    assert _records(plan) == _records(jplan)
    assert _groups(plan) == _groups(jplan)
    assert plan.total_bytes == jplan.total_bytes


@pytest.mark.parametrize("arch", DENSE)
def test_decode_plan_matches_jax_smoke(arch):
    plan = Server(get_smoke_config(arch), device="cpu", max_len=64).plan(2)
    jplan = JServer(jget_smoke(arch), max_len=64).plan(2)
    _assert_same_plan(plan, jplan)
    assert len(plan.collections()) >= 9


def test_decode_plan_matches_jax_chatglm3_full_size():
    """chatglm3-6b at full size, abstract on both sides: 15 records, 12
    collections (the stacked layer leaves), 4 groups in JAX's order."""
    plan = Server(get_config("chatglm3_6b"), device="cpu", max_len=1024).plan(4)
    jplan = JServer(jget_config("chatglm3_6b"), max_len=1024).plan(4)
    _assert_same_plan(plan, jplan)
    assert len(plan.records) == 15 and len(plan.collections()) == 12
    groups = _groups(plan)
    assert len(groups) == 4
    assert groups[0] == {"embed"} and groups[2] == {"final_norm"} and groups[3] == {"lm_head"}
    assert groups[1] == {r.path for r in plan.collections()}
    assert [{r.path for r in g} for g in plan.groups()] == groups  # the streamer's groups
    assert plan.total_bytes == 24_974_336_000  # f32, as the abstract parameters are


def test_plan_of_concrete_params_equals_abstract():
    """Concrete tensors are traced as meta tensors of their shapes: the plan
    is the abstract one and nothing runs."""
    cfg = get_smoke_config("qwen1_5_4b")
    model = Model(cfg, device="cpu")
    step = lambda p, c, t: model.decode_step(p, c, t, 3)  # noqa: E731
    tokens = torch.zeros((2, 1), dtype=torch.int64)
    cache = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in model.abstract_cache(2, 8).items()}
    a = build_access_plan(step, model.abstract_params(), model.abstract_cache(2, 8), tokens)
    c = build_access_plan(step, model.init_params(seed=0), cache, tokens)
    assert _records(a) == _records(c) and _groups(a) == _groups(c)
    assert not cache["k"].any()  # the decode's in-place cache write never ran


@pytest.mark.parametrize("arch,records,collections,groups", [
    ("falcon_mamba_7b", 13, 10, 4),     # the layer stack: one scanned group
    ("recurrentgemma_2b", 24, 0, 24),   # a Python loop of static slices
])
def test_decode_plan_matches_jax_recurrent_smoke(arch, records, collections, groups):
    plan = Server(get_smoke_config(arch), device="cpu", max_len=64).plan(2)
    jplan = JServer(jget_smoke(arch), max_len=64).plan(2)
    _assert_same_plan(plan, jplan)
    assert (len(plan.records), len(plan.collections()), len(_groups(plan))) == \
        (records, collections, groups)


def test_decode_plan_matches_jax_falcon_mamba_full_size():
    """falcon-mamba-7b at full size, abstract on both sides: 13 records, the
    10 stacked layer leaves as collections in one group, 4 groups."""
    plan = Server(get_config("falcon_mamba_7b"), device="cpu", max_len=544).plan(4)
    jplan = JServer(jget_config("falcon_mamba_7b"), max_len=544).plan(4)
    _assert_same_plan(plan, jplan)
    groups = _groups(plan)
    assert [len(g) for g in groups] == [1, 10, 1, 1]
    assert groups[0] == {"embed"} and groups[2] == {"final_norm"} and groups[3] == {"lm_head"}
    assert groups[1] == {r.path for r in plan.collections()}
    assert plan.total_bytes == 29_090_660_352  # f32, as the abstract parameters are


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "granite_moe_1b_a400m"])
def test_decode_plan_matches_jax_moe_smoke(arch):
    """The router and the three expert banks are one record each, the whole
    stacked bank (CAPre's superset of the experts a token may take), in the
    layer stack's group."""
    plan = Server(get_smoke_config(arch), device="cpu", max_len=64).plan(2)
    jplan = JServer(jget_smoke(arch), max_len=64).plan(2)
    _assert_same_plan(plan, jplan)
    by_path = {r.path: r for r in plan.records}
    for leaf in ("router", "we_gate", "we_up", "we_down"):
        assert by_path[f"layers.mlp.{leaf}"].collection


def test_decode_plan_matches_jax_qwen3_moe_full_size():
    """qwen3-moe-30b-a3b at full size, abstract on both sides: the 12
    stacked layer leaves (4 of them the router and expert banks, 28.99e9
    of the 30.53e9 parameters) in one group between the embedding and the
    final norm and head."""
    plan = Server(get_config("qwen3_moe_30b_a3b"), device="cpu", max_len=1024).plan(4)
    jplan = JServer(jget_config("qwen3_moe_30b_a3b"), max_len=1024).plan(4)
    _assert_same_plan(plan, jplan)
    groups = _groups(plan)
    assert [len(g) for g in groups] == [1, 12, 1, 1]
    assert groups[0] == {"embed"} and groups[2] == {"final_norm"} and groups[3] == {"lm_head"}
    assert groups[1] == {r.path for r in plan.collections()}
    banks = sum(r.nbytes for r in plan.records if r.path.split(".")[-1].startswith("we_"))
    assert banks == 4 * 28_991_029_248  # f32, as the abstract parameters are
    assert plan.total_bytes == 4 * 30_532_646_912
