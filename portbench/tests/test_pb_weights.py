"""The weights the benchmark makes: the dense tree is bitwise what it was
before the moe family was added (a digest taken then), and each smoke
configuration's tree has the program's layout."""

import hashlib

import pytest
import torch

from pb import spec, weights

DATA = spec.BENCH_DIR / "tests" / "data"
# chatglm3-smoke at seed 2**33 + 5, before the moe leaves were added
DENSE_DIGEST = "59be38f3d56b23b51392675ffd06319057e9a5d23dd29f9bb78370ea43d638bd"


def digest(tree: dict) -> str:
    h = hashlib.sha256()
    for p, t in sorted(weights.leaves(tree)):
        h.update(p.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.view(torch.int16).numpy().tobytes())
    return h.hexdigest()


def test_dense_tree_unchanged():
    cfg = spec.load_json(DATA / "configs" / "chatglm3-smoke.json")
    assert digest(weights.make(cfg, 2**33 + 5, torch.device("cpu"))) == DENSE_DIGEST


@pytest.mark.parametrize("name", ["chatglm3-smoke", "qwen3moe-smoke"])
def test_layout_is_the_programs(name):
    import run
    from repro_torch.models.model import Model

    cfg = spec.load_json(DATA / "configs" / f"{name}.json")
    model = Model(run.program_config(cfg), device="meta")
    want = {p: tuple(t.shape) for p, t in weights.leaves(model.abstract_params())}
    tree = weights.make(cfg, 7, torch.device("cpu"))
    assert {p: tuple(t.shape) for p, t in weights.leaves(tree)} == want
    assert all(t.dtype == torch.bfloat16 for _, t in weights.leaves(tree))


def test_moe_banks_are_drawn():
    """Every expert of every bank differs from the others and has the
    layout's spread."""
    cfg = spec.load_json(DATA / "configs" / "qwen3moe-smoke.json")
    tree = weights.make(cfg, 11, torch.device("cpu"))
    for name in ("router", "we_gate", "we_up", "we_down"):
        w = tree["layers"]["mlp"][name].float()
        assert w.std().item() == pytest.approx(0.02, rel=0.1), name
    bank = tree["layers"]["mlp"]["we_gate"].float().flatten(2)  # [L, E, d * f]
    assert torch.cdist(bank[0], bank[0]).fill_diagonal_(1.0).min() > 0
