"""The port's training substrate on the CPU: twins of the checkpoint,
straggler, data-pipeline, optimizer and schedule cases of
tests/test_runtime_substrate.py, checkpoints restored across the two
packages (parameters and optimizer state, both ways), and AdamW against the
JAX package's over three updates of a random tree.

Tolerances: checkpoints are bit for bit; AdamW in f32 within 1e-5 (rtol and
atol: the same operations, with the bias corrections and the learning rate
in double precision on the host instead of f32).
"""

import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # beside the other test workers on the CPU

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.data import SyntheticLMSource as JSyntheticLMSource  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import warmup_cosine as jwarmup_cosine  # noqa: E402
from repro_torch.checkpoint import CheckpointError, CheckpointManager  # noqa: E402
from repro_torch.convert import from_numpy_tree, to_numpy_tree  # noqa: E402
from repro_torch.data import DataPipeline, SyntheticLMSource  # noqa: E402
from repro_torch.models.common import tree_items, tree_map  # noqa: E402
from repro_torch.optim import AdamW, warmup_cosine  # noqa: E402
from repro_torch.runtime.fault import StragglerDetector  # noqa: E402

# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "a": torch.from_numpy(rng.randn(8, 16).astype(np.float32)),
        "nested": {"b": torch.from_numpy(rng.randn(3, 4).astype(np.float32)),
                   "step": torch.tensor(7, dtype=torch.int32)},
    }


def _assert_trees_equal(got, want):
    got, want = dict(tree_items(got)), dict(tree_items(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g, w), path


def test_checkpoint_roundtrip_and_integrity(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    t = _tree()
    t["half"] = torch.randn(5, 3).to(torch.bfloat16)
    mgr.save(5, t)
    meta = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), t)
    step, restored = mgr.restore(like=meta)
    assert step == 5
    _assert_trees_equal(restored, t)


def test_checkpoint_keep_k_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_async_overlaps_and_waits(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3, async_save=True)
    t = _tree()
    mgr.save(1, t)
    mgr.save(2, t)  # waits for save 1 implicitly
    mgr.wait()
    assert set(mgr.all_steps()) == {1, 2}


def test_checkpoint_crash_mid_save_keeps_previous(tmp_path):
    """A .tmp directory (simulated crash) is never picked up by restore."""
    mgr = CheckpointManager(tmp_path, keep=3, async_save=False)
    mgr.save(1, _tree())
    (tmp_path / "step_0000000002.tmp.0").mkdir()
    assert mgr.latest_step() == 1
    step, _ = mgr.restore(like=_tree())
    assert step == 1


def test_checkpoint_corruption_detected(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3, async_save=False)
    mgr.save(1, _tree())
    leaf = next((tmp_path / "step_0000000001").glob("leaf_*.npy"))
    np.save(leaf, np.load(leaf) + 1.0)
    with pytest.raises(CheckpointError, match="crc"):
        mgr.restore(like=_tree())


def test_checkpoint_shape_mismatch_detected(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3, async_save=False)
    mgr.save(1, _tree())
    bad = {"a": torch.zeros((9, 16)), "nested": {"b": torch.zeros((3, 4)),
                                                  "step": torch.tensor(0)}}
    with pytest.raises(CheckpointError, match="shape"):
        mgr.restore(like=bad)


def _train_state():
    """chatglm3 smoke parameters and a nonzero AdamW state from JAX."""
    cfg = jget_smoke("chatglm3_6b")
    params = JModel(cfg).init_params(jax.random.PRNGKey(0))
    opt = JAdamW()
    state = opt.init(params)
    grads = jax.tree.map(lambda p: 1e-2 * jnp.ones_like(p), params)
    params, state, _ = opt.update(grads, state, params)
    return {"params": params, "opt": state}


def test_port_restores_a_jax_checkpoint(tmp_path):
    jtree = _train_state()
    jtree["extra"] = {"half": jnp.asarray(np.arange(6, dtype=np.float32).astype(
        ml_dtypes.bfloat16))}
    JCheckpointManager(tmp_path, async_save=False).save(3, jtree)
    want = from_numpy_tree(jax.tree.map(np.asarray, jtree), device="cpu")
    step, got = CheckpointManager(tmp_path).restore(like=want)
    assert step == 3
    _assert_trees_equal(got, want)


def test_jax_restores_a_port_checkpoint(tmp_path):
    jtree = _train_state()
    CheckpointManager(tmp_path, async_save=False).save(
        4, from_numpy_tree(jax.tree.map(np.asarray, jtree), device="cpu"))
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jtree)
    step, got = JCheckpointManager(tmp_path).restore(like=like)
    assert step == 4
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jtree)[0],
                            jax.tree.leaves(got)):
        assert np.asarray(b).dtype == np.asarray(a).dtype, path
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


# ---------------------------------------------------------------------------
# Stragglers
# ---------------------------------------------------------------------------


def test_straggler_detector_flags_persistent_outlier():
    det = StragglerDetector(threshold=3.0, min_samples=4, patience=2)
    for _ in range(3):
        for n in range(6):
            det.record(f"n{n}", 0.100 + 0.001 * n)
        det.record("slow", 0.500)
        flagged = det.check()
    assert flagged == ["slow"]


def test_straggler_detector_ignores_one_off_blip():
    det = StragglerDetector(threshold=3.0, min_samples=4, patience=3)
    for n in range(6):
        det.record(f"n{n}", 0.1)
    det.record("blip", 0.9)
    assert det.check() == []
    for n in range(6):
        det.record(f"n{n}", 0.1)
    det.record("blip", 0.1)
    assert det.check() == []


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------


def test_pipeline_deterministic_and_resumable():
    src = SyntheticLMSource(vocab_size=100, batch=2, seq_len=8, seed=42)
    p1 = DataPipeline(src, start_step=0, prefetch=2)
    first = [next(p1) for _ in range(5)]
    p1.close()
    p2 = DataPipeline(src, start_step=3, prefetch=2)
    s, b = next(p2)
    p2.close()
    assert s == 3
    np.testing.assert_array_equal(b["inputs"], first[3][1]["inputs"])
    # the same (seed, step) gives JAX's batch
    want = JSyntheticLMSource(vocab_size=100, batch=2, seq_len=8, seed=42).batch_at(3)
    for k in ("inputs", "targets"):
        np.testing.assert_array_equal(b[k], want[k])


def test_pipeline_prefetches_ahead():
    p = DataPipeline(SyntheticLMSource(vocab_size=50, batch=1, seq_len=4), prefetch=4)
    deadline = time.monotonic() + 5.0
    while p.produced < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert p.produced >= 4  # producer ran ahead without a consumer
    p.close()


# ---------------------------------------------------------------------------
# Optimizer and schedule
# ---------------------------------------------------------------------------


def test_adamw_converges_on_quadratic():
    opt = AdamW(learning_rate=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}  # d/dw sum(w^2)
        params, state, metrics = opt.update(grads, state, params)
    assert float(params["w"].abs().max()) < 1e-2
    assert float(metrics["grad_norm"]) >= 0


def test_warmup_cosine_shape():
    sched = warmup_cosine(1e-3, warmup_steps=10, total_steps=100)
    lrs = [sched(s) for s in (0, 5, 10, 50, 100)]
    assert lrs[0] < lrs[1] < lrs[2]
    assert lrs[2] == pytest.approx(1e-3, rel=1e-3)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(1e-4, rel=1e-2)
    jsched = jwarmup_cosine(1e-3, warmup_steps=10, total_steps=100)
    for s, lr in zip((0, 5, 10, 50, 100, 150), lrs + [sched(150)]):
        assert lr == pytest.approx(float(jsched(jnp.asarray(s))), rel=1e-6)


def test_adamw_matches_jax_over_three_updates():
    """Same random tree, same gradients (one set large enough to be clipped):
    parameters, moments, gradient norm and learning rate after each update."""
    rng = np.random.RandomState(0)
    tree = {"w": rng.randn(16, 8), "b": np.zeros(8), "n": {"scale": np.ones(8)}}
    tree = {"w": tree["w"].astype(np.float32), "b": tree["b"].astype(np.float32),
            "n": {"scale": tree["n"]["scale"].astype(np.float32)}}
    jopt = JAdamW(learning_rate=jwarmup_cosine(1e-2, 2, 10))
    opt = AdamW(learning_rate=warmup_cosine(1e-2, 2, 10))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    params = from_numpy_tree(tree, device="cpu")
    state = opt.init(params)
    for i, gscale in enumerate((0.1, 5.0, 0.01)):
        grads = jax.tree.map(lambda a: (gscale * rng.randn(*a.shape)).astype(np.float32), tree)
        jparams, jstate, jm = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        params, state, m = opt.update(from_numpy_tree(grads, device="cpu"), state, params)
        assert int(state["step"]) == int(jstate["step"]) == i + 1
        assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        for got, want in ((params, jparams), (state["mu"], jstate["mu"]),
                          (state["nu"], jstate["nu"])):
            for (path, g), (_, w) in zip(tree_items(to_numpy_tree(got)),
                                         tree_items(jax.tree.map(np.asarray, want))):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=path)
