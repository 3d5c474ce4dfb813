"""The port's placement-as-a-policy, held to tests/test_placement.py's
claims at its sizes: pluggable placement, replica-aware routing, failure
scenarios (straggler / crash / failover), demand stealing, and the
placement-equivalence and ``baseline.csv`` byte-identity checks through
``repro_torch.predict.evaluate``.  Every recording runs with the trace
cache off.  Nothing is left out.
"""

import csv
import threading

import pytest

from repro_torch.pos.client import POSClient
from repro_torch.pos.latency import ZERO, LatencyModel, make_scenario
from repro_torch.pos.placement import (
    ConsistentHashPlacement,
    LocalityAwarePlacement,
    RoundRobinPlacement,
    available_placements,
    make_placement,
    spread,
)
from repro_torch.pos.store import (
    ExecutionContext,
    NoReplicaAvailable,
    ObjectStore,
    ServiceCrashed,
)
from repro_torch.predict.evaluate import _catalog, evaluate_workload, record_workload
from repro_torch.runtime.fault import StoreFaultDetector


# ---------------------------------------------------------------------------
# placement policies (unit)
# ---------------------------------------------------------------------------


def test_spread_walks_distinct_services_with_wraparound():
    assert spread(3, 4, 2) == (3, 0)
    assert spread(1, 4, 1) == (1,)
    assert spread(0, 4, 3) == (0, 1, 2)
    # replication capped at the service count
    assert spread(2, 3, 9) == (2, 0, 1)


def test_round_robin_matches_legacy_counter():
    p = RoundRobinPlacement(4, 1)
    assert [p.place(oid, "C") for oid in range(1, 6)] == [
        (0,), (1,), (2,), (3,), (0,)
    ]


def test_consistent_hash_is_deterministic_and_distinct():
    a = ConsistentHashPlacement(4, 2)
    b = ConsistentHashPlacement(4, 2)
    for oid in range(1, 50):
        reps = a.place(oid, "C")
        assert reps == b.place(oid, "C")  # pure function of the oid
        assert len(reps) == 2 and len(set(reps)) == 2


def test_locality_colocates_groups_and_rotates_ungrouped():
    p = LocalityAwarePlacement(4, 1)
    g1 = [p.place(oid, "C", group="g1") for oid in (1, 2, 3)]
    assert len({reps[0] for reps in g1}) == 1  # whole group on one service
    g2 = p.place(4, "C", group="g2")
    assert g2[0] != g1[0][0]  # next group lands on the next service
    # ungrouped objects keep consuming the same rotation
    singles = {p.place(oid, "C")[0] for oid in range(5, 9)}
    assert len(singles) == 4


def test_make_placement_rejects_unknown_policy():
    with pytest.raises(KeyError, match="unknown placement"):
        make_placement("nope", 4, 1)
    assert set(available_placements()) == {
        "round-robin", "consistent-hash", "locality"
    }


# ---------------------------------------------------------------------------
# store mechanics: replication, pinning, rebuild
# ---------------------------------------------------------------------------


def test_replication_registers_one_shared_instance():
    store = ObjectStore(n_services=4, latency=ZERO, replication=2)
    oid = store.put("C", {"x": 1})
    reps = store.replicas_of(oid)
    assert len(reps) == 2
    objs = [store.services[r].disk[oid] for r in reps]
    assert objs[0] is objs[1]  # field state trivially consistent


def test_pinned_put_does_not_advance_the_policy():
    pinned = ObjectStore(n_services=4, latency=ZERO)
    control = ObjectStore(n_services=4, latency=ZERO)
    a1 = pinned.put("C")
    pinned.put("C", ds=3)  # pinned: no counter consumption
    a2 = pinned.put("C")
    b1 = control.put("C")
    b2 = control.put("C")
    assert pinned.replicas_of(a1) == control.replicas_of(b1)
    assert pinned.replicas_of(a2) == control.replicas_of(b2)


def test_rebuild_placement_preserves_objects_and_honours_groups():
    store = ObjectStore(n_services=4, latency=ZERO)
    oids = [store.put("C", {"v": i}, group=f"g{i // 3}") for i in range(9)]
    before = {oid: store.peek(oid).fields["v"] for oid in oids}
    store.rebuild_placement("locality", replication=2)
    assert store.placement_name == "locality"
    for oid in oids:
        assert store.peek(oid).fields["v"] == before[oid]
        assert len(store.replicas_of(oid)) == 2
    # each group of three shares one primary after the rebuild
    for g in range(3):
        primaries = {store.replicas_of(oids[g * 3 + i])[0] for i in range(3)}
        assert len(primaries) == 1


# ---------------------------------------------------------------------------
# failure handling: crash, failover, detection
# ---------------------------------------------------------------------------


def test_demand_fails_over_to_surviving_replica():
    store = ObjectStore(n_services=4, latency=ZERO, replication=2)
    oid = store.put("C", {"x": 7})
    primary = store.replicas_of(oid)[0]
    store.crash_service(primary)
    ctx = ExecutionContext(store)
    obj = store.app_access(ctx, oid)
    assert obj.fields["x"] == 7
    assert primary in store._down
    assert store.metrics.services_crashed == 1


def test_unreplicated_crash_leaves_no_replica():
    store = ObjectStore(n_services=4, latency=ZERO, replication=1)
    oid = store.put("C")
    store.crash_service(store.replicas_of(oid)[0])
    with pytest.raises(NoReplicaAvailable):
        store.app_access(ExecutionContext(store), oid)


def test_silent_crash_detected_by_error_fast_path():
    """A crash nobody announced: routing still targets the service, the
    load raises ServiceCrashed, and the demand path retries a replica."""
    store = ObjectStore(n_services=4, latency=ZERO, replication=2)
    oid = store.put("C", {"x": 1})
    primary = store.replicas_of(oid)[0]
    store.services[primary].crash()  # service-level: store not told
    assert primary not in store._down
    obj = store.app_access(ExecutionContext(store), oid)
    assert obj.fields["x"] == 1
    assert primary in store._down  # the error path announced it
    assert store.metrics.failovers >= 1


def test_heartbeat_monitor_flags_silent_service():
    store = ObjectStore(n_services=4, latency=ZERO, replication=2)
    t = [0.0]
    det = store.attach_fault_detection(heartbeat_timeout=1.0,
                                      clock=lambda: t[0], check_every=1)
    assert isinstance(det, StoreFaultDetector)
    t[0] = 2.0
    for ds_id in (1, 2, 3):
        det.beat(ds_id)
    det.tick(force=True)
    assert 0 in store._down
    assert {1, 2, 3}.isdisjoint(store._down)


def test_straggler_detector_flags_slow_disk():
    store = ObjectStore(n_services=4, latency=ZERO)
    det = store.attach_fault_detection(straggler_threshold=2.0,
                                      straggler_min_samples=4,
                                      straggler_patience=1, check_every=1)
    for _ in range(3):
        det.beat(0, 1.0)  # persistently ~100x the fleet median
        for ds_id in (1, 2, 3):
            det.beat(ds_id, 0.01)
    det.tick(force=True)
    assert 0 in store._slow
    assert store.metrics.stragglers_flagged >= 1


def test_prefetch_batch_redispatches_from_crashed_service():
    store = ObjectStore(n_services=4, latency=ZERO, replication=2)
    oids = [store.put("C", {"v": i}) for i in range(8)]
    victim = store.replicas_of(oids[0])[0]
    store.services[victim].crash()  # silent: routing still targets it
    store.prefetch_batch(oids)
    assert store.metrics.failovers >= 1
    # every oid is resident on some surviving replica
    for oid in oids:
        assert any(oid in store.services[r].cache
                   for r in store.replicas_of(oid) if r != victim)


# ---------------------------------------------------------------------------
# demand stealing (satellite 1)
# ---------------------------------------------------------------------------


def test_demand_steals_claimed_but_unstarted_prefetch():
    store = ObjectStore(n_services=4, latency=ZERO)
    oid = store.put("C", {"x": 5})
    ds = store.service_of(oid)
    # a lane claimed the oid but has not started loading: steal window open
    ev = threading.Event()
    ev.lane_pending = True
    with ds._cache_lock:
        ds._inflight[oid] = ev
    obj = store.app_access(ExecutionContext(store), oid)
    assert obj.fields["x"] == 5
    assert ds.demand_steals == 1
    assert getattr(ev, "stolen", False)
    assert ev.is_set()  # coalesced waiters wake on the same event
    assert oid in ds.cache


def test_lane_skips_stolen_oids_without_loading():
    latency = LatencyModel(disk_load=0.0, remote_hop=0.0, write_back=0.0,
                           think=0.0, parallel_per_ds=1)
    store = ObjectStore(n_services=4, latency=latency)
    oid = store.put("C")
    ds = store.service_of(oid)
    ds._slots.acquire()  # hold the only disk arm: the lane parks pre-slot
    lane = threading.Thread(target=ds.load_batch, args=([oid],))
    lane.start()
    deadline = threading.Event()
    for _ in range(2000):
        with ds._cache_lock:
            ev = ds._inflight.get(oid)
            if ev is not None and getattr(ev, "lane_pending", False):
                break
        deadline.wait(0.001)
    else:
        pytest.fail("lane never claimed the oid")
    with ds._cache_lock:  # a demand stealer took it over
        ev.lane_pending = False
        ev.stolen = True
    ds._slots.release()
    lane.join(timeout=5.0)
    assert not lane.is_alive()
    assert ds.prefetch_loads == 0  # the lane dropped the stolen oid
    with ds._cache_lock:  # the event now belongs to the stealer
        assert ds._inflight.get(oid) is ev
        ds._inflight.pop(oid)
    ev.set()


# ---------------------------------------------------------------------------
# live crash under replication: all five apps complete correctly
# ---------------------------------------------------------------------------


APPS = ("bank", "wordcount", "kmeans", "oo7", "pga")


def _run_app(app: str, crash_after: int = 0):
    wl = _catalog()[app]
    client = POSClient(n_services=4, latency=ZERO, replication=2)
    client.register(wl.build_app())
    root = wl.populate(client.store)
    store = client.store
    with client.session(wl.name, mode="capre", parallel_workers=4) as s:
        if crash_after:
            seen = [0]

            def on_access(_oid, _store=store, _seen=seen):
                _seen[0] += 1
                if _seen[0] == crash_after:
                    _store.crash_service(0)

            store.access_listener = on_access
        result = wl.run_once(s, root)
        s.drain(30.0)
    return result, store


@pytest.mark.parametrize("app", APPS)
def test_apps_complete_correctly_through_service_crash(app):
    clean, _ = _run_app(app)
    crashed, store = _run_app(app, crash_after=20)
    assert crashed == clean  # identical traversal result despite the crash
    assert store.metrics.services_crashed == 1
    assert not store.services[0].alive


# ---------------------------------------------------------------------------
# replay acceptance: equivalence, byte-identity, failure regimes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bank_recorded():
    return record_workload(_catalog()["bank"], runs=2)


def test_placement_equivalence_no_fault(bank_recorded):
    """With no failures the placement policy moves objects, not
    predictions: the prefetched sets — hence precision/recall/coverage —
    are identical for every predictor under every policy."""
    wl = _catalog()["bank"]
    per_policy = {}
    for placement in available_placements():
        rows = evaluate_workload(
            wl, modes=("capre", "rop"), recorded=bank_recorded,
            placement=placement, dispatch_modes=("batch",),
        )
        per_policy[placement] = {
            r.predictor: (r.precision, r.recall, r.coverage) for r in rows
        }
    baseline = per_policy["round-robin"]
    for placement, by_pred in per_policy.items():
        assert by_pred == baseline, f"{placement} changed the prefetched sets"


def test_round_robin_replication_one_reproduces_baseline_csv(bank_recorded):
    """The refactor's null case is byte-identical: default placement at
    replication 1 must reproduce the committed baseline.csv
    timely_coverage cells exactly (same floats, not within-tolerance)."""
    want = {}
    with open("artifacts/predict/baseline.csv", newline="") as fh:
        for row in csv.DictReader(fh):
            key = (row["app"], row["workload"], row["predictor"],
                   row["cache_capacity"], row["policy"], row["dispatch"])
            want[key] = row["timely_coverage"]
    wl = _catalog()["bank"]
    rows = evaluate_workload(wl, modes=("capre", "rop"),
                             recorded=bank_recorded,
                             cache_capacities=(0, 64), policies=("lru",),
                             dispatch_modes=("per-oid",))
    assert rows
    for r in rows:
        key = (r.app, r.workload, r.predictor, str(r.cache_capacity),
               r.policy, r.dispatch)
        assert key in want, f"baseline.csv lost row {key}"
        assert str(r.timely_coverage) == want[key], key


def test_crash_scenario_fails_over_and_degrades_gracefully(bank_recorded):
    wl = _catalog()["bank"]
    rows = evaluate_workload(
        wl, modes=("capre",), recorded=bank_recorded,
        placement="locality", replication=2,
        cache_capacities=(64,), policies=("lru",),
        scenarios=("no-fault", "straggler", "crash"),
    )
    by_scenario = {r.scenario: r for r in rows}
    assert set(by_scenario) == {"no-fault", "straggler", "crash"}
    clean, straggler, crash = (by_scenario[s] for s in
                               ("no-fault", "straggler", "crash"))
    assert crash.failovers > 0  # in-flight prefetches re-dispatched
    # every access was still served (completeness under failure): the
    # accessed universe (TP + FN) is the same in every regime
    accessed = clean.true_positives + clean.false_negatives
    assert crash.true_positives + crash.false_negatives == accessed
    assert straggler.true_positives + straggler.false_negatives == accessed
    # faults cost timeliness, never correctness
    assert crash.timely_coverage < clean.timely_coverage
    assert straggler.stall_seconds > clean.stall_seconds
    assert clean.scenario == "no-fault" and crash.replication == 2
    assert crash.placement == "locality"


def test_make_scenario_anchors_crash_inside_the_run():
    sc = make_scenario("crash", end_t=1.0)
    assert sc.is_fault and sc.crash_service == 0
    assert 0.0 < sc.crash_at < 1.0
    clean = make_scenario("no-fault", end_t=1.0)
    assert not clean.is_fault and clean.crash_service is None
    slow = make_scenario("straggler", end_t=1.0, straggler_scale=8.0)
    assert slow.straggler_scales().get(0) == 8.0
