"""The plain reference agrees with the program where both compute in f32,
at the smoke configurations: a prefill at batch 1, the decode ticks that
follow it through the cache, and a batcher's requests whole.

Both sides read the same weights in f32 and differ only in the order of
their sums (the program's one-hot dispatch and combine add zeros; its
attention goes in chunks), so logits agree to about 1e-6; the tolerances
(1e-5 absolute, 1e-4 relative) leave room for that and lie far below what
one expert routed otherwise, or one pair dropped, changes (some 1e-2 at
these sizes)."""

import numpy as np
import pytest
import torch

import run
from pb import spec, weights
from pb.reference import Reference

DATA = spec.BENCH_DIR / "tests" / "data"
CONFIGS = ["chatglm3-smoke", "qwen3moe-smoke"]


def _setup(name, seed=7):
    from repro_torch.models.model import Model

    cfg = spec.load_json(DATA / "configs" / f"{name}.json")
    tree = weights.make(cfg, seed, torch.device("cpu"))
    tree32 = {p: t.float() for p, t in weights.leaves(tree)}
    nested: dict = {}
    for p, t in tree32.items():
        node = nested
        *parents, leaf = p.split(".")
        for q in parents:
            node = node.setdefault(q, {})
        node[leaf] = t
    model = Model(run.program_config(cfg).replace(compute_dtype="float32"), device="cpu")
    return cfg, nested, model


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill(name):
    cfg, tree, model = _setup(name)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg["vocab_size"], 40))
    with torch.inference_mode():
        logits, cache = model.prefill(tree, {"inputs": tokens[None]})
    ref = Reference(cfg, tree)
    (h, k, v), = ref.forward([tokens], [39])
    assert torch.allclose(logits[0, 0], ref.logits(h)[0], atol=1e-5, rtol=1e-4)
    assert torch.allclose(cache["k"][:, 0], k, atol=1e-5)
    assert torch.allclose(cache["v"][:, 0], v, atol=1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_through_the_cache(name):
    """A prefill, then the batcher's decode ticks (eager, in f32): each
    tick's logits are the reference's at that position of the whole
    sequence."""
    from repro_torch.runtime.scheduler import ContinuousBatcher, Request

    cfg, tree, model = _setup(name)
    b = ContinuousBatcher(model, tree, 2, 64, device="cpu")
    prompt = np.random.default_rng(3).integers(0, cfg["vocab_size"], 21)
    req = Request(0, prompt, 7)
    b.submit(req)
    got = []
    with torch.inference_mode():
        while not req.done:
            b.step()
            got.append(b.logits[0, 0].clone())
    assert len(req.output) == 7 and len(got) == 6
    seq = torch.as_tensor(np.concatenate([prompt, req.output[:-1]]))
    ref = Reference(cfg, tree)
    (h, _, _), = ref.forward([seq], [len(prompt) - 1])
    want = ref.logits(h)
    assert want.shape[0] == 7
    assert torch.allclose(torch.stack(got), want[1:], atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("name", CONFIGS)
def test_batcher_requests_whole(name):
    """A batcher whose slots fill and empty, in f32: the check reads every
    served token the reference's own and every cache row its value."""
    from pb import check
    from repro_torch.runtime.scheduler import ContinuousBatcher, Request

    cfg, tree, model = _setup(name)
    b = ContinuousBatcher(model, tree, 4, 64, device="cpu")
    rng = np.random.default_rng(2)
    reqs = [Request(i, rng.integers(0, cfg["vocab_size"], S), n)
            for i, (S, n) in enumerate(((9, 12), (17, 5), (30, 9), (5, 20), (11, 3)))]
    for r in reqs:
        b.submit(r)
    with torch.inference_mode():
        for _ in range(10):
            b.step()
    state = check.State.take(b, [{"req": r} for r in reqs])
    assert state.finished and state.in_slots
    with torch.inference_mode():
        got, _ = check.compare(cfg, tree, state, 3, {"finished": 4, "in_slots": 4})
    assert got["tokens"] == sum(len(r.output) for r in reqs)
    assert got["gap"] < 1e-4 and got["kv_rms"] < 1e-5, got
