"""Fault tolerance machinery for pod-scale runs.  Counterpart of
``repro.runtime.fault``, an own copy (the port imports nothing of the JAX
package):

  * **HeartbeatMonitor**: workers post heartbeats; a check flags nodes that
    miss ``timeout`` seconds as failed and invokes the recovery callback
    once per incident;
  * **ElasticPlanner**: given the surviving device count, the largest valid
    mesh (full model axis; the data axis shrinks), the re-balanced global
    batch (pairs with the checkpoint restore, which re-shards);
  * **StragglerDetector**: per-step duration tracking with a robust
    (median + MAD) z-score; persistent stragglers are reported;
  * **TrainSupervisor**: runs a step function under failure detection; on
    a ``NodeFailure`` it shrinks the mesh through the planner and resumes
    from the last checkpoint.

The object store's detector (``StoreFaultDetector``) belongs with the
object-store stack (ROADMAP.md, section 1, item 8).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


class HeartbeatMonitor:
    def __init__(self, node_ids, timeout: float = 5.0, on_failure: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.on_failure = on_failure
        self.clock = clock
        self._last = {n: clock() for n in node_ids}
        self._failed: set = set()
        self._lock = threading.Lock()

    def beat(self, node_id) -> None:
        with self._lock:
            self._last[node_id] = self.clock()
            # a node that comes back is still considered failed until the
            # controller re-admits it explicitly

    def readmit(self, node_id) -> None:
        with self._lock:
            self._failed.discard(node_id)
            self._last[node_id] = self.clock()

    def check(self) -> list:
        """Returns newly failed nodes (invokes the callback once each)."""
        now = self.clock()
        newly = []
        with self._lock:
            for n, t in self._last.items():
                if n not in self._failed and now - t > self.timeout:
                    self._failed.add(n)
                    newly.append(n)
        for n in newly:
            if self.on_failure:
                self.on_failure(n)
        return newly

    @property
    def healthy(self) -> list:
        with self._lock:
            return [n for n in self._last if n not in self._failed]

    @property
    def failed(self) -> set:
        with self._lock:
            return set(self._failed)


@dataclass
class MeshPlan:
    data: int
    model: int
    pods: int = 1
    global_batch: int = 0

    @property
    def chips(self) -> int:
        return self.pods * self.data * self.model


class ElasticPlanner:
    """Recompute the mesh after losing nodes.

    Policy: the model axis is sacred (TP groups must stay whole: losing any
    chip of a 16-wide TP group kills the whole group), so recovery drops
    whole data-parallel rows; the global batch is kept by increasing the
    per-shard batch (grad accumulation) when divisible, else reduced to the
    nearest multiple.
    """

    def __init__(self, model_axis: int = 16, pods: int = 1):
        self.model_axis = model_axis
        self.pods = pods

    def plan(self, surviving_chips: int, global_batch: int) -> MeshPlan:
        rows = surviving_chips // self.model_axis
        if rows < 1:
            raise RuntimeError("fewer surviving chips than one model group")
        # keep pods only if every pod retains the same row count
        pods = self.pods if rows % self.pods == 0 else 1
        data = rows // pods
        batch = global_batch
        if batch % (pods * data):
            batch = (batch // (pods * data)) * (pods * data)
            batch = max(batch, pods * data)
        return MeshPlan(data=data, model=self.model_axis, pods=pods, global_batch=batch)


class StragglerDetector:
    """Robust per-node step-duration outlier detection (median + MAD)."""

    def __init__(self, threshold: float = 4.0, min_samples: int = 5, patience: int = 3):
        self.threshold = threshold
        self.min_samples = min_samples
        self.patience = patience
        self._durations: dict = {}
        self._strikes: dict = {}

    def record(self, node_id, seconds: float) -> None:
        self._durations.setdefault(node_id, []).append(seconds)

    def check(self) -> list:
        """Nodes whose last step is a persistent outlier."""
        lasts = {n: d[-1] for n, d in self._durations.items() if d}
        if len(lasts) < self.min_samples:
            return []
        vals = sorted(lasts.values())
        med = vals[len(vals) // 2]
        mad = sorted(abs(v - med) for v in vals)[len(vals) // 2] or 1e-9
        out = []
        for n, v in lasts.items():
            if (v - med) / (1.4826 * mad) > self.threshold:
                self._strikes[n] = self._strikes.get(n, 0) + 1
                if self._strikes[n] >= self.patience:
                    out.append(n)
            else:
                self._strikes[n] = 0
        return out


@dataclass
class SupervisorReport:
    steps_completed: int = 0
    failures_handled: int = 0
    restores: int = 0
    final_chips: int = 0
    events: list = field(default_factory=list)


class TrainSupervisor:
    """Drives a (simulated or real) training loop under failure injection.

    ``step_fn(step_index, mesh_plan) -> None`` may raise ``NodeFailure`` to
    simulate a lost worker; the supervisor shrinks the mesh and resumes from
    the last checkpoint step."""

    def __init__(self, planner: ElasticPlanner, checkpoint_mgr, save_every: int = 10):
        self.planner = planner
        self.ckpt = checkpoint_mgr
        self.save_every = save_every

    def run(self, step_fn, state, total_steps: int, chips: int, global_batch: int) -> SupervisorReport:
        report = SupervisorReport()
        plan = self.planner.plan(chips, global_batch)
        step = 0
        self.ckpt.save(0, state, wait=True)
        last_saved = 0
        while step < total_steps:
            try:
                state = step_fn(step, plan, state)
                step += 1
                report.steps_completed += 1
                if step % self.save_every == 0:
                    self.ckpt.save(step, state, wait=True)
                    last_saved = step
            except NodeFailure as f:
                report.failures_handled += 1
                chips -= f.lost_chips
                plan = self.planner.plan(chips, global_batch)
                report.events.append(
                    f"step {step}: lost {f.lost_chips} chips -> mesh {plan.pods}x{plan.data}x{plan.model}"
                )
                step, state = self.ckpt.restore(like=state)
                report.restores += 1
        report.final_chips = plan.chips
        return report


class NodeFailure(Exception):
    def __init__(self, lost_chips: int = 16):
        super().__init__(f"lost {lost_chips} chips")
        self.lost_chips = lost_chips
