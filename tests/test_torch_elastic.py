"""The port's elastic supervision (``runtime/fault.py``) against the JAX
package's: twins of ``test_runtime_substrate.py``'s heartbeat, planner and
supervisor tests, each held to what the JAX classes give on the same
inputs; the supervisor restoring through the port's ``CheckpointManager``."""

import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.runtime import fault as jfault
from repro_torch.checkpoint import CheckpointManager
from repro_torch.runtime.fault import (
    ElasticPlanner,
    HeartbeatMonitor,
    MeshPlan,
    NodeFailure,
    TrainSupervisor,
)


def _drill(mon_cls):
    clock = [0.0]
    failures = []
    mon = mon_cls(["n0", "n1", "n2"], timeout=5.0, on_failure=failures.append,
                  clock=lambda: clock[0])
    clock[0] = 3.0
    mon.beat("n0")
    mon.beat("n1")
    clock[0] = 6.0
    first = mon.check()
    clock[0] = 20.0
    second = mon.check()  # n0 and n1 fall silent now; n2 is not reported twice
    failed = mon.failed
    healthy = sorted(mon.healthy)
    mon.readmit("n2")
    return first, second, failures, failed, healthy, sorted(mon.healthy)


def test_heartbeat_failure_detection():
    got = _drill(HeartbeatMonitor)
    assert got == _drill(jfault.HeartbeatMonitor)
    first, second, failures, failed, healthy, readmitted = got
    assert first == ["n2"] and "n2" not in second
    assert failures == ["n2", "n0", "n1"]
    assert failed == {"n0", "n1", "n2"} and healthy == []
    assert readmitted == ["n2"]


@pytest.mark.parametrize("pods", [1, 2])
def test_elastic_planner_drops_dp_rows_keeps_tp(pods):
    p, jp = ElasticPlanner(model_axis=16, pods=pods), jfault.ElasticPlanner(16, pods=pods)
    for chips in range(16, 512 * pods + 1, 8):
        for batch in (1, 96, 256):
            got, want = p.plan(chips, batch), jp.plan(chips, batch)
            assert (got.pods, got.data, got.model, got.global_batch, got.chips) == (
                want.pods, want.data, want.model, want.global_batch, want.chips)
            assert got.model == 16 and got.global_batch % (got.pods * got.data) == 0
    full = ElasticPlanner(model_axis=16, pods=2).plan(512, global_batch=256)
    assert full == MeshPlan(data=16, model=16, pods=2, global_batch=256)
    with pytest.raises(RuntimeError, match="model group"):
        p.plan(15, 8)


def test_supervisor_recovers_from_injected_failures(tmp_path):
    """Failures at steps 7 and 23 lose a node each; the supervisor re-plans
    the mesh and resumes from the last checkpoint, as JAX's does."""

    def drill(sup_cls, planner, mgr, zero, fail_cls):
        fail_at = {7, 23}
        calls = []

        def step_fn(step, plan, state):
            calls.append((step, plan.chips))
            if step in fail_at:
                fail_at.discard(step)
                raise fail_cls(lost_chips=16)
            return {**state, "x": state["x"] + 1.0}

        report = sup_cls(planner, mgr, save_every=5).run(step_fn, {"x": zero}, total_steps=30,
                                                          chips=256, global_batch=256)
        _, state = mgr.restore(like={"x": zero})
        return report, calls, float(state["x"])

    got = drill(TrainSupervisor, ElasticPlanner(model_axis=16),
                CheckpointManager(tmp_path / "port", keep=3, async_save=False),
                torch.zeros(()), NodeFailure)
    want = drill(jfault.TrainSupervisor, jfault.ElasticPlanner(model_axis=16),
                 JCheckpointManager(tmp_path / "jax", keep=3, async_save=False),
                 jnp.zeros(()), jfault.NodeFailure)
    (report, calls, x), (jreport, jcalls, jx) = got, want
    assert (report.steps_completed, report.failures_handled, report.restores,
            report.final_chips, report.events) == (
        jreport.steps_completed, jreport.failures_handled, jreport.restores,
        jreport.final_chips, jreport.events)
    assert calls == jcalls and x == jx == 30.0
    assert report.failures_handled == 2 and report.restores == 2
    assert report.final_chips == 256 - 2 * 16
