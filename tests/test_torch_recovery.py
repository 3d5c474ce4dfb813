"""The port's partition-tolerant recovery, held to tests/test_recovery.py's
claims at its sizes: network partitions and heal, readmission and
anti-entropy resync, write quorums, hedged reads and fault detection under
churn, on the live threaded store and on the replay's virtual clock
(``repro_torch.predict.evaluate``, ``repro_torch.predict.loadsim``).  Every
recording runs with the trace cache off.  Nothing is left out.
"""

import threading

import pytest

from repro_torch.pos.client import POSClient  # noqa: F401  (parity with suite imports)
from repro_torch.pos.latency import ZERO, LatencyModel, make_scenario
from repro_torch.pos.store import (
    ExecutionContext,
    ObjectStore,
    QuorumUnreachable,
    RetryExhausted,
    ServiceCrashed,
)
from repro_torch.predict.evaluate import (
    _catalog,
    record_workload,
    replay_baseline,
)
from repro_torch.predict.loadsim import run_loadsim


# ---------------------------------------------------------------------------
# live store: partitions, heal, readmission
# ---------------------------------------------------------------------------


def test_partition_reads_fail_over_and_heal_readmits():
    store = ObjectStore(n_services=4, latency=ZERO, replication=2)
    oid = store.put("C", {"x": 7})
    primary = store.replicas_of(oid)[0]
    store.partition([[], [primary]])  # primary lands on the minority side
    assert store.metrics.partitions == 1
    obj = store.app_access(ExecutionContext(store), oid)
    assert obj.fields["x"] == 7  # the reachable replica served it
    assert primary in store._down  # announced: routing avoids it outright
    assert store.metrics.failovers == 0  # no failed attempt was needed
    # a write during the cut cannot reach the cut replica: logged for resync
    store.app_write(oid)
    store.heal_partition()
    assert not store._net_cut
    assert primary not in store._down
    assert store.metrics.readmissions == 1
    assert store.metrics.resync_lines >= 1  # anti-entropy replayed the write
    assert store.metrics.lost_writes == 0


def test_partition_unannounced_is_caught_by_the_error_path():
    store = ObjectStore(n_services=4, latency=ZERO, replication=2)
    oid = store.put("C", {"x": 1})
    primary = store.replicas_of(oid)[0]
    store.partition([[], [primary]], announce=False)
    assert primary not in store._down  # undetected: routing still targets it
    obj = store.app_access(ExecutionContext(store), oid)
    assert obj.fields["x"] == 1
    assert primary in store._down  # ...until the failed load announced it
    assert store.metrics.failovers >= 1  # the error path paid the reroute


def test_revive_service_readmits_cold():
    store = ObjectStore(n_services=4, latency=ZERO, replication=2)
    oid = store.put("C", {"x": 3})
    victim = store.replicas_of(oid)[0]
    store.crash_service(victim)
    assert victim in store._down
    store.revive_service(victim)
    assert victim not in store._down
    assert store.services[victim].alive
    assert not store.services[victim].cache  # cold — the crash lost it
    assert store.metrics.readmissions == 1
    obj = store.app_access(ExecutionContext(store), oid)
    assert obj.fields["x"] == 3


def test_revive_resyncs_writes_missed_while_dead():
    store = ObjectStore(n_services=4, latency=ZERO, replication=2)
    oid = store.put("C", {"x": 0})
    victim = store.replicas_of(oid)[0]
    store.crash_service(victim)
    store.app_write(oid)  # served by the survivor; victim misses it
    flushed_before = store.metrics.flushed_writes
    store.revive_service(victim)
    assert store.metrics.resync_lines == 1
    assert store.metrics.flushed_writes == flushed_before + 1


def test_per_session_failover_attribution():
    store = ObjectStore(n_services=4, latency=ZERO, replication=2)
    oid = store.put("C", {"x": 1})
    store.services[store.replicas_of(oid)[0]].crash()  # silent
    ctx = ExecutionContext(store, session_label="tenant-a")
    store.app_access(ctx, oid)
    assert store.failovers_by_session.get("tenant-a", 0) >= 1


# ---------------------------------------------------------------------------
# live store: write-loss accounting and retry hygiene
# ---------------------------------------------------------------------------


def test_flush_on_dead_service_fails_over_to_replica():
    store = ObjectStore(n_services=4, latency=ZERO, replication=2)
    oid = store.put("C")
    primary = store.replicas_of(oid)[0]
    ds = store.services[primary]
    store.app_write(oid)
    ds.alive = False  # dies with the dirty line still queued for flush
    ds._flush(oid)
    assert store.metrics.lost_writes == 0
    assert store.metrics.flushed_writes >= 1  # the replica took the write-back


def test_flush_with_no_replica_counts_a_lost_write():
    store = ObjectStore(n_services=4, latency=ZERO, replication=1)
    oid = store.put("C")
    ds = store.services[store.replicas_of(oid)[0]]
    store.app_write(oid)
    ds.alive = False
    ds._flush(oid)
    assert store.metrics.lost_writes == 1


def test_demand_retries_are_bounded():
    store = ObjectStore(n_services=4, latency=ZERO, replication=2)
    oid = store.put("C")
    dead = store.services[store.replicas_of(oid)[0]]
    dead.crash()  # silent — and routing is pinned to the corpse below
    store._route_demand = lambda _oid: dead
    with pytest.raises(RetryExhausted) as exc:
        store.app_access(ExecutionContext(store), oid)
    assert exc.value.attempts == store.MAX_FAILOVER_RETRIES + 1
    assert store.metrics.failover_retries == store.MAX_FAILOVER_RETRIES


# ---------------------------------------------------------------------------
# live store: write quorums
# ---------------------------------------------------------------------------


def test_write_quorum_charges_synchronous_acks():
    store = ObjectStore(n_services=4, latency=ZERO, replication=2,
                        write_quorum=2)
    oid = store.put("C")
    store.app_write(oid)
    assert store.metrics.quorum_writes == 1
    assert store.metrics.quorum_acks == 1  # W-1 acks for W=2
    assert store.metrics.quorum_failures == 0


def test_write_quorum_unreachable_across_partition():
    store = ObjectStore(n_services=4, latency=ZERO, replication=2,
                        write_quorum=2)
    oid = store.put("C")
    other = store.replicas_of(oid)[1]
    store.partition([[], [other]])  # the ack-ing replica is across the cut
    with pytest.raises(QuorumUnreachable) as exc:
        store.app_write(oid)
    assert exc.value.wanted == 2 and exc.value.got == 1
    assert store.metrics.quorum_failures == 1
    assert store.metrics.quorum_retries == store.MAX_QUORUM_RETRIES
    # the local write stood (sloppy): the object is dirty on the primary
    primary = store.services[store.replicas_of(oid)[0]]
    assert oid in primary.dirty


def test_write_quorum_dirties_acking_replicas_resident_lines():
    store = ObjectStore(n_services=4, latency=ZERO, replication=2,
                        write_quorum=2)
    oid = store.put("C")
    reps = store.replicas_of(oid)
    store.services[reps[1]].load_into_memory(oid)  # resident on the ack-er
    store.app_write(oid)
    assert oid in store.services[reps[1]].dirty


# ---------------------------------------------------------------------------
# live store: hedged reads
# ---------------------------------------------------------------------------


def test_hedged_read_wins_on_straggling_primary():
    latency = LatencyModel(disk_load=2e-3, remote_hop=0.0, write_back=0.0,
                           think=0.0).with_stragglers({0: 50.0})
    store = ObjectStore(n_services=4, latency=latency, replication=2,
                        hedge=True, hedge_delay=5e-3)
    oid = store.put("C", {"x": 9})  # round-robin: primary is service 0
    assert store.replicas_of(oid)[0] == 0
    obj = store.app_access(ExecutionContext(store), oid)
    assert obj.fields["x"] == 9
    assert store.metrics.hedged_reads == 1
    assert store.metrics.hedge_wins == 1  # 100ms primary lost to 2ms alt


def test_hedge_does_not_fire_on_fast_primary():
    store = ObjectStore(n_services=4, latency=ZERO, replication=2,
                        hedge=True, hedge_delay=1.0)
    oid = store.put("C")
    store.app_access(ExecutionContext(store), oid)
    assert store.metrics.hedged_reads == 0


# ---------------------------------------------------------------------------
# fault detection under churn
# ---------------------------------------------------------------------------


def test_detector_survives_crash_revive_churn():
    """Heartbeat/straggler ticks racing crash and revive threads: no
    exceptions, and a final readmission leaves every service routable."""
    store = ObjectStore(n_services=4, latency=ZERO, replication=2)
    det = store.attach_fault_detection(heartbeat_timeout=1e6, check_every=1)
    oids = [store.put("C", {"v": i}) for i in range(16)]
    stop = threading.Event()
    errors = []

    def churn():
        try:
            for _ in range(100):
                store.crash_service(0)
                store.revive_service(0)
        except Exception as exc:  # pragma: no cover - the assertion payload
            errors.append(exc)
        finally:
            stop.set()

    th = threading.Thread(target=churn)
    th.start()
    reader_errors = 0
    while not stop.is_set():
        for ds_id in range(4):
            det.beat(ds_id, 1e-4)
        det.tick(force=True)
        for oid in oids[:4]:
            try:
                store.app_access(ExecutionContext(store), oid)
            except (ServiceCrashed, RetryExhausted):
                reader_errors += 1  # bounded failure beats a hang
    th.join(timeout=10.0)
    assert not th.is_alive() and not errors
    store.revive_service(0)
    assert not store._down
    for oid in oids:
        assert store.app_access(ExecutionContext(store), oid) is not None


def test_readmission_clears_straggler_flag_and_history():
    store = ObjectStore(n_services=4, latency=ZERO)
    det = store.attach_fault_detection(straggler_threshold=2.0,
                                      straggler_min_samples=4,
                                      straggler_patience=1, check_every=1)
    for _ in range(3):
        det.beat(0, 1.0)
        for ds_id in (1, 2, 3):
            det.beat(ds_id, 0.01)
    det.tick(force=True)
    assert 0 in store._slow
    store.revive_service(0)
    assert 0 not in store._slow
    assert store.metrics.readmissions == 1
    # a clean baseline: the old strikes must not re-flag it instantly
    det.tick(force=True)
    assert 0 not in store._slow


# ---------------------------------------------------------------------------
# virtual clock: the same recovery semantics, deterministically
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bank_recorded():
    wl = _catalog()["bank"]
    return wl, record_workload(wl, runs=2)


@pytest.fixture(scope="module")
def bank_write_recorded():
    wl = _catalog()["bank_write"]
    return wl, record_workload(wl, runs=2)


def _end_t(trace, store):
    clean = replay_baseline(trace, store)
    return clean.t - clean.stall_seconds


def test_virtual_partition_fails_over_and_heals(bank_recorded):
    _, (client, _root, traces) = bank_recorded
    store = client.store
    store.rebuild_placement("round-robin", replication=2)
    trace = traces[-1]
    sc = make_scenario("partition", end_t=_end_t(trace, store))
    engine = replay_baseline(trace, store, scenario=sc)
    assert engine.failovers > 0
    assert engine.readmissions >= 1  # the heal fired at heal_at
    assert not engine.cut  # nothing left unreachable at the end
    assert not engine.dead


def test_virtual_crash_revive_readmits(bank_recorded):
    _, (client, _root, traces) = bank_recorded
    store = client.store
    store.rebuild_placement("round-robin", replication=2)
    trace = traces[-1]
    sc = make_scenario("crash+revive", end_t=_end_t(trace, store))
    engine = replay_baseline(trace, store, scenario=sc)
    assert engine.readmissions == 1
    assert not engine.dead  # revived before the run ended


def test_virtual_quorum_prices_replicated_writes(bank_write_recorded):
    _, (client, _root, traces) = bank_write_recorded
    store = client.store
    store.rebuild_placement("round-robin", replication=2)
    trace = traces[-1]
    sloppy = replay_baseline(trace, store, write_quorum=1)
    quorum = replay_baseline(trace, store, write_quorum=2)
    assert quorum.quorum_writes > 0
    assert quorum.quorum_acks == quorum.quorum_writes  # W-1 acks each, W=2
    assert quorum.stall_seconds > sloppy.stall_seconds  # consistency costs
    assert quorum.quorum_failures == 0  # both replicas healthy throughout


def test_virtual_hedge_cuts_straggler_stall(bank_recorded):
    _, (client, _root, traces) = bank_recorded
    store = client.store
    store.rebuild_placement("round-robin", replication=2)
    trace = traces[-1]
    plain = replay_baseline(trace, store,
                            scenario=make_scenario("straggler"))
    hedged = replay_baseline(trace, store,
                             scenario=make_scenario("straggler+hedge"))
    assert hedged.hedged_reads > 0
    assert hedged.hedge_wins > 0
    assert hedged.stall_seconds <= plain.stall_seconds


def test_virtual_replay_is_deterministic_under_faults(bank_recorded):
    _, (client, _root, traces) = bank_recorded
    store = client.store
    store.rebuild_placement("round-robin", replication=2)
    trace = traces[-1]
    end_t = _end_t(trace, store)
    for name in ("partition", "crash+revive", "straggler+hedge"):
        sc = make_scenario(name, end_t=end_t)
        a = replay_baseline(trace, store, scenario=sc, write_quorum=2)
        b = replay_baseline(trace, store, scenario=sc, write_quorum=2)
        assert (a.t, a.stall_seconds, a.failovers, a.readmissions,
                a.hedged_reads) == \
               (b.t, b.stall_seconds, b.failovers, b.readmissions,
                b.hedged_reads), name


# ---------------------------------------------------------------------------
# multi-tenant virtual loadsim under faults
# ---------------------------------------------------------------------------


def test_loadsim_partition_scenario_is_deterministic():
    kwargs = dict(tenants=8, jobs=1, scenario="partition", replication=2,
                  cache_capacity=64)
    a = run_loadsim(**kwargs)
    b = run_loadsim(**kwargs)
    assert a.rows() == b.rows()
    assert a.scenario == "partition"
    assert a.failovers >= 1  # the cut's detection charge at minimum


def test_loadsim_rows_carry_scenario_and_failover_columns():
    report = run_loadsim(tenants=4, jobs=1, scenario="crash", replication=2,
                         cache_capacity=64)
    rows = report.rows()
    assert rows and all("scenario" in r and "failovers" in r for r in rows)
    assert all(r["scenario"] == "crash" for r in rows)
