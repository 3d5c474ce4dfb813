"""Latency/cost model of the simulated dataClay deployment.

The paper's cluster: 5 nodes, 10GbE, 5400rpm HDDs — data access is dominated
by (a) pulling an object from the Data Service's disk into its memory and
(b) redirecting execution between Data Services over the network.  We model
both with real ``time.sleep`` so that genuinely concurrent prefetch threads
(the paper uses JVM thread pools + parallel streams) produce genuine
wall-clock improvements, and provide a zero-latency mode so unit tests are
fast and fully deterministic.

All latencies are in seconds.  Sub-50µs latencies are treated as free
(Python's sleep granularity would otherwise distort them).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

_MIN_SLEEP = 50e-6


@dataclass(frozen=True)
class LatencyModel:
    disk_load: float = 300e-6  # DS disk -> DS memory (the cost prefetch hides)
    remote_hop: float = 120e-6  # execution redirection between Data Services
    write_back: float = 350e-6  # storing an updated object
    think: float = 100e-6  # per-object application processing time
    parallel_per_ds: int = 4  # concurrent disk loads per DS (4-core nodes)
    # per-task submission cost of the prefetch executor — only consulted by
    # the virtual clock (the live store pays it for real in Python executor
    # overhead): each dispatch serializes on the submitting side, so a
    # per-oid dispatcher issues its i-th load ~i*dispatch_overhead late,
    # while a batched dispatcher pays it once per Data-Service batch
    dispatch_overhead: float = 0.0
    # per-service disk-time multipliers (straggler regimes): service i's
    # disk_load and write_back scale by service_scales[i]; services past the
    # tuple's end (or an empty tuple — the default) run at 1.0.  This is how
    # a slow/degraded Data Service enters the cost model without touching
    # the cluster-wide constants.
    service_scales: tuple[float, ...] = ()
    # what a demand access pays to notice a dead service and re-route to a
    # replica (failover detection + retry); only charged on actual failover
    failover_detect: float = 0.0

    def sleep(self, seconds: float) -> None:
        if seconds >= _MIN_SLEEP:
            time.sleep(seconds)

    def scale_for(self, ds_id: int) -> float:
        if 0 <= ds_id < len(self.service_scales):
            return self.service_scales[ds_id]
        return 1.0

    def disk_load_for(self, ds_id: int) -> float:
        return self.disk_load * self.scale_for(ds_id)

    def write_back_for(self, ds_id: int) -> float:
        return self.write_back * self.scale_for(ds_id)

    def with_stragglers(self, scales: dict[int, float]) -> "LatencyModel":
        """A copy where service ``i`` runs ``scales[i]`` times slower on
        disk (1.0 elsewhere) — the per-service slow/straggler regime."""
        from dataclasses import replace

        width = max(scales) + 1 if scales else 0
        return replace(
            self,
            service_scales=tuple(scales.get(i, 1.0) for i in range(width)),
        )

    @property
    def is_zero(self) -> bool:
        return self.disk_load == 0 and self.remote_hop == 0 and self.write_back == 0

    def scaled(self, scale: float) -> "LatencyModel":
        """A copy with every *time* constant multiplied by ``scale`` (slot
        counts and the per-service straggler multipliers untouched) — how
        the fitted wall-vs-virtual calibration factors
        (``predict.calibration``) are applied to a replay model."""
        from dataclasses import replace

        return replace(
            self,
            disk_load=self.disk_load * scale,
            remote_hop=self.remote_hop * scale,
            write_back=self.write_back * scale,
            think=self.think * scale,
            dispatch_overhead=self.dispatch_overhead * scale,
            failover_detect=self.failover_detect * scale,
        )


ZERO = LatencyModel(disk_load=0.0, remote_hop=0.0, write_back=0.0, think=0.0)
DEFAULT = LatencyModel()


def now() -> float:
    return time.perf_counter()


# ---------------------------------------------------------------------------
# pure cost arithmetic (no sleeping) — the virtual-clock side of the model
# ---------------------------------------------------------------------------


class VirtualDisk:
    """Pure-arithmetic model of one Data Service's disk under the same
    constants ``LatencyModel.sleep`` burns for real: ``parallel_per_ds``
    service slots, each load occupying a slot for ``disk_load`` seconds.

    ``predict.evaluate`` replays recorded traces against this instead of
    sleeping, so a predicted object gets a deterministic *ready-at* time
    (including queueing behind other loads on the same service — where
    over-eager predictors congest their own prefetches)."""

    def __init__(self, latency: LatencyModel, scale: float = 1.0):
        self.latency = latency
        # per-service straggler multiplier (1.0 = nominal): scales this
        # disk's service times without touching the shared LatencyModel
        self._disk_load = latency.disk_load * scale
        self._write_back = latency.write_back * scale
        self._slots = [0.0] * max(1, latency.parallel_per_ds)
        self.loads = 0
        self.write_backs = 0
        self.busy_seconds = 0.0
        self.last_slot = 0  # slot index taken by the most recent _occupy

    def _occupy(self, t: float, seconds: float) -> tuple[float, float]:
        i = min(range(len(self._slots)), key=self._slots.__getitem__)
        start = max(t, self._slots[i])
        done = start + seconds
        self._slots[i] = done
        self.busy_seconds += seconds
        self.last_slot = i
        return start, done

    def schedule(self, t: float) -> tuple[float, float]:
        """Schedule one disk load requested at virtual time ``t``; returns
        ``(start, done)``.  The load takes the earliest-free slot: it starts
        at ``max(t, slot_free)`` and completes ``disk_load`` later."""
        self.loads += 1
        return self._occupy(t, self._disk_load)

    def schedule_batch(self, t: float, n: int) -> list[tuple[float, float]]:
        """Schedule ``n`` disk loads, all requested at virtual time ``t`` —
        one batched prefetch request pipelining through the service's slots.
        Identical slot arithmetic to ``n`` separate ``schedule`` calls; the
        batching win is modeled at the *dispatch* layer (one
        ``dispatch_overhead`` charge per batch instead of per oid)."""
        return [self.schedule(t) for _ in range(n)]

    def schedule_write_back(self, t: float) -> tuple[float, float]:
        """Schedule one write-back (dirty-eviction flush) requested at
        virtual time ``t``.  Write-backs occupy the *same* service slots as
        loads for ``write_back`` seconds — the flush itself is off the
        application's critical path, but it delays whatever loads queue
        behind it, which is how the replay charges the write path."""
        self.write_backs += 1
        return self._occupy(t, self._write_back)


# Constants used by the offline replay engine: the paper's HDD regime, where
# per-object disk latency dwarfs per-object compute (5400rpm: milliseconds vs
# sub-millisecond think).  An access-ahead miner can only buy ``think`` worth
# of lead per step, far short of one disk load — method-level lead (CAPre's
# injected scheduling point) is what arrives early enough.  Aggregate disk
# bandwidth (n_services x parallel_per_ds) still exceeds the application's
# consumption rate, so a predictor with enough lead CAN fully hide the disk:
# timeliness, not bandwidth, is what the replay measures.
REPLAY = LatencyModel(
    disk_load=2e-3, remote_hop=120e-6, write_back=4e-3, think=250e-6, parallel_per_ds=2,
    dispatch_overhead=50e-6,
)


# ---------------------------------------------------------------------------
# failure scenarios — the regimes the replay engine and bench_placement sweep
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FailureScenario:
    """One failure regime for a replay/bench run.

    ``straggler`` is ``((ds_id, disk_scale), ...)``: those services' disk
    times multiply by the scale (the slow-service regime).  ``crash_service``
    (with ``crash_at`` in virtual seconds) kills one service mid-run: its
    cache and in-flight loads are lost, claimed-but-unlanded prefetches
    re-dispatch to a surviving replica after ``failover_delay``, and demand
    reads route around the corpse (replication >= 2 required — with a single
    replica the data is simply gone and the replay raises)."""

    name: str = "no-fault"
    straggler: tuple[tuple[int, float], ...] = ()
    crash_service: Optional[int] = None
    crash_at: float = float("inf")
    failover_delay: float = 2e-3
    # network partition: ``partition`` is a tuple of service-id groups; group
    # 0 is the client-side majority (unlisted services implicitly belong to
    # it).  Between ``partition_at`` and ``heal_at`` every service outside
    # group 0 is unreachable: demand/prefetch traffic to it fails like a
    # crash, but its state survives — at ``heal_at`` it readmits with a warm
    # cache and anti-entropy resyncs the dirty lines it missed.
    partition: tuple[tuple[int, ...], ...] = ()
    partition_at: float = float("inf")
    heal_at: float = float("inf")
    # crash+revive: a service crashed at ``crash_at`` comes back (cold cache)
    # at ``revive_at`` and readmits into routing
    revive_at: float = float("inf")
    # hedged reads: demand misses issue to a second replica after a
    # hedge delay and take the first response.  ``hedge_delay`` 0.0 means
    # "derive" (the store/replay derives it from the latency model's p99).
    hedge: bool = False
    hedge_delay: float = 0.0

    @property
    def is_fault(self) -> bool:
        return (bool(self.straggler) or self.crash_service is not None
                or bool(self.partition))

    def straggler_scales(self) -> dict[int, float]:
        return dict(self.straggler)

    def cut_services(self) -> set[int]:
        """Services unreachable from the client side while partitioned
        (everything outside group 0)."""
        if not self.partition:
            return set()
        return {ds for grp in self.partition[1:] for ds in grp}


#: scenario vocabulary bench_placement / evaluate sweep by name
SCENARIO_NAMES = ("no-fault", "straggler", "crash", "partition",
                  "crash+revive", "straggler+hedge")


def make_scenario(name: str, end_t: float = 0.0, ds_id: int = 0,
                  straggler_scale: float = 8.0,
                  crash_frac: float = 0.25) -> FailureScenario:
    """Resolve a named regime: ``straggler`` makes ``ds_id`` run
    ``straggler_scale`` times slower on disk; ``crash`` kills ``ds_id`` at
    ``crash_frac`` of the no-fault baseline's end time ``end_t`` (mid-run,
    so in-flight prefetch batches are caught on the dead service);
    ``partition`` isolates ``ds_id`` from the client-side majority between
    25% and 70% of ``end_t`` (heal readmits it warm and resyncs missed
    writes); ``crash+revive`` kills ``ds_id`` at 25% and revives it cold at
    60%; ``straggler+hedge`` is the straggler regime with hedged demand
    reads armed."""
    if name == "no-fault":
        return FailureScenario()
    if name == "straggler":
        return FailureScenario(name=name, straggler=((ds_id, straggler_scale),))
    if name == "crash":
        return FailureScenario(name=name, crash_service=ds_id,
                               crash_at=end_t * crash_frac)
    if name == "partition":
        return FailureScenario(name=name, partition=((), (ds_id,)),
                               partition_at=end_t * crash_frac,
                               heal_at=end_t * 0.70)
    if name == "crash+revive":
        return FailureScenario(name=name, crash_service=ds_id,
                               crash_at=end_t * crash_frac,
                               revive_at=end_t * 0.60)
    if name == "straggler+hedge":
        return FailureScenario(name=name,
                               straggler=((ds_id, straggler_scale),),
                               hedge=True)
    raise KeyError(f"unknown failure scenario {name!r}; expected one of {SCENARIO_NAMES}")
