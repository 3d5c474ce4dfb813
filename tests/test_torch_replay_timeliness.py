"""The port's timeliness-aware replay engine
(``repro_torch.predict.evaluate``), held to
tests/test_replay_timeliness.py's claims at its sizes: virtual-clock stall
arithmetic on hand-built traces, disk-slot queueing, bounded-cache thrash
accounting, the cache-capacity sweep, parallel recording determinism, the
CSV artifact's shape, and the write path end to end (write-allocate and
dirty-bit accounting, write-back occupancy, the mutating bank workload,
listener isolation, counter resets).  Every recording runs with the trace
cache off.

Left out: the three gate tests of ``benchmarks/compare_predict.py``
(tests/test_replay_timeliness.py:449, 485, 519), which the port does not
carry.
"""

import csv

import pytest

from repro_torch.apps.bank import build_bank_app, populate_bank_store
from repro_torch.pos.client import POSClient
from repro_torch.pos.latency import REPLAY, LatencyModel, VirtualDisk
from repro_torch.pos.store import ObjectStore
from repro_torch.pos.trace import TraceEvent, trace_oids
from repro_torch.predict.base import Predictor
from repro_torch.predict.evaluate import (
    CSV_COLUMNS,
    RecordedTrace,
    _catalog,
    evaluate_workload,
    record_catalog,
    record_workload,
    replay,
    replay_baseline,
    write_csv,
)

# disk_load=10, think=1: every stall below is exact integer arithmetic
LAT = LatencyModel(disk_load=10.0, remote_hop=0.0, write_back=0.0, think=1.0,
                   parallel_per_ds=2)


class Scripted(Predictor):
    """Emit a fixed oid list at method entry and/or per-access."""

    name = "scripted"

    def __init__(self, on_entry=(), on_access_map=None):
        super().__init__()
        self._on_entry = list(on_entry)
        self._on_access = dict(on_access_map or {})

    def on_method_entry(self, method_key, this_oid):
        return self._emit(list(self._on_entry))

    def on_access(self, oid, cls):
        return self._emit(list(self._on_access.get(oid, ())))


def _store_with(n_objects: int, n_services: int = 1) -> tuple[ObjectStore, list[int]]:
    store = ObjectStore(n_services=n_services)
    oids = [store.put("Obj", {}) for _ in range(n_objects)]
    return store, oids


# ---------------------------------------------------------------------------
# VirtualDisk slot arithmetic
# ---------------------------------------------------------------------------


def test_virtual_disk_schedules_on_earliest_free_slot():
    disk = VirtualDisk(LAT)  # 2 slots, 10s per load
    assert disk.schedule(0.0) == (0.0, 10.0)
    assert disk.schedule(0.0) == (0.0, 10.0)  # second slot
    assert disk.schedule(0.0) == (10.0, 20.0)  # queues behind the first
    assert disk.schedule(25.0) == (25.0, 35.0)  # idle gap: starts on request
    assert disk.loads == 4
    assert disk.busy_seconds == pytest.approx(40.0)


# ---------------------------------------------------------------------------
# virtual-clock replay: hand-built traces with known stall arithmetic
# ---------------------------------------------------------------------------


def test_method_entry_prediction_arrives_timely():
    """3-event trace: enter predicts b a whole access ahead, so b's load
    (0 -> 10) lands before its need (t=11): one timely hit, and the only
    stall is a's unpredicted demand load."""
    store, (a, b) = _store_with(2)
    trace = RecordedTrace("t", "m", [("enter", "Obj.m", a), ("access", a), ("access", b)], [a, b])
    res = replay(trace, Scripted(on_entry=[b]), store, None, latency=LAT)
    # access a: demand load 0 -> 10 (stall 10), think -> 11
    # access b: prefetched load completed at 10 <= 11 -> timely, no stall
    assert res.stall_seconds == pytest.approx(10.0)
    assert res.timely_coverage == pytest.approx(0.5)
    assert res.partial_hide == 0.0
    assert res.overhead["hidden_seconds"] == pytest.approx(10.0)
    assert res.overhead["late_predictions"] == 0
    # baseline pays both demand loads: 10 + 10
    assert res.baseline_stall_seconds == pytest.approx(20.0)
    assert res.stall_saved_pct == pytest.approx(50.0)


def test_access_chained_prediction_only_partially_hides():
    """Predicting b only upon accessing a (miner-style, one access of lead)
    leaves the load in flight at need: the app waits out the remainder."""
    store, (a, b) = _store_with(2)
    trace = RecordedTrace("t", "m", [("access", a), ("access", b)], [a, b])
    res = replay(trace, Scripted(on_access_map={a: [b]}), store, None, latency=LAT)
    # access a: demand 0 -> 10 (stall 10), think -> 11; b predicted at 11,
    # load 11 -> 21; access b needed at 11: in flight -> stall 21-11 = 10
    assert res.stall_seconds == pytest.approx(20.0)
    assert res.timely_coverage == 0.0
    assert res.partial_hide == pytest.approx(0.5)
    assert res.overhead["late_predictions"] == 1
    assert res.coverage == pytest.approx(0.5)  # order-aware coverage ignores lateness


def test_demand_load_queues_behind_prefetch_on_one_disk_arm():
    """With a single slot per service, an over-eager prefetch delays the
    application's own demand load — the congestion cost the wall-clock
    benchmarks pay for real."""
    store, (a, b) = _store_with(2)
    lat1 = LatencyModel(disk_load=10.0, remote_hop=0.0, write_back=0.0, think=1.0,
                        parallel_per_ds=1)
    trace = RecordedTrace("t", "m", [("enter", "Obj.m", a), ("access", a), ("access", b)], [a, b])
    res = replay(trace, Scripted(on_entry=[b]), store, None, latency=lat1)
    # b's prefetch takes the only slot (0 -> 10); a's demand load queues
    # (10 -> 20): stall 20, then b is long since resident (timely)
    assert res.stall_seconds == pytest.approx(20.0)
    assert res.timely_coverage == pytest.approx(0.5)


def test_remote_hop_advances_the_needed_at_clock():
    """Objects on different services charge execution redirection before
    the load: needed-at includes the hop, exactly like the live store."""
    lat = LatencyModel(disk_load=10.0, remote_hop=3.0, write_back=0.0, think=1.0,
                       parallel_per_ds=2)
    store, _ = _store_with(0, n_services=2)
    a = store.put("Obj", {}, ds=0)
    b = store.put("Obj", {}, ds=1)
    trace = RecordedTrace("t", "m", [("access", a), ("access", b)], [a, b])
    engine = replay_baseline(trace, store, latency=lat)
    # hop (3) + load a (3 -> 13) + think -> 14; hop (-> 17) + load b (17 -> 27)
    assert engine.remote_hops == 2
    assert engine.stall_seconds == pytest.approx(20.0)
    assert engine.t == pytest.approx(28.0)


# ---------------------------------------------------------------------------
# bounded cache: evictions, thrash, the capacity sweep
# ---------------------------------------------------------------------------


def test_bounded_cache_counts_thrash_and_unused_prefetch_evictions():
    store, (a, b, u) = _store_with(3)
    events = [("enter", "Obj.m", a), ("access", a), ("access", b), ("access", a)]
    trace = RecordedTrace("t", "m", events, [a, b, a])
    res = replay(trace, Scripted(on_entry=[u]), store, None, latency=LAT, cache_capacity=1)
    # u's useless prefetch lands and immediately evicts a; b then evicts u
    # (never used); re-accessing a is a full miss caused by eviction
    assert res.evictions >= 2
    assert res.overhead["evicted_before_use"] == 1
    assert res.thrash_misses == 1
    assert res.false_positives == 1  # u was never accessed


def test_unbounded_cache_never_evicts_and_rereads_hit():
    store, (a, b) = _store_with(2)
    trace = RecordedTrace("t", "m", [("access", a), ("access", b), ("access", a)], [a, b, a])
    engine = replay_baseline(trace, store, latency=LAT, cache_capacity=0)
    assert engine.evictions == 0 and engine.thrash_misses == 0
    assert engine.stall_seconds == pytest.approx(20.0)  # only the two cold misses


def test_cache_capacity_sweep_produces_one_row_per_capacity():
    wl = _catalog()["bank"]
    results = evaluate_workload(wl, modes=("capre",), cache_capacities=(0, 8))
    assert [r.cache_capacity for r in results] == [0, 8]
    unbounded, tiny = results
    assert unbounded.evictions == 0
    # bank's working set (~250 objects over 4 services) cannot fit in 8
    # slots per service: the bounded run must evict and stall more
    assert tiny.evictions > 0
    assert tiny.stall_seconds > unbounded.stall_seconds


# ---------------------------------------------------------------------------
# the write path: VirtualDisk occupancy, replay arithmetic, store accounting
# ---------------------------------------------------------------------------

# disk_load=10, write_back=4, think=1, ONE slot: flush delays are exact
LATW = LatencyModel(disk_load=10.0, remote_hop=0.0, write_back=4.0, think=1.0,
                    parallel_per_ds=1)


def test_virtual_disk_write_back_occupies_the_same_slots():
    disk = VirtualDisk(LATW)  # 1 slot: loads queue behind flushes
    assert disk.schedule(0.0) == (0.0, 10.0)
    assert disk.schedule_write_back(10.0) == (10.0, 14.0)
    assert disk.schedule(10.0) == (14.0, 24.0)  # queues behind the flush
    assert disk.loads == 2 and disk.write_backs == 1
    assert disk.busy_seconds == pytest.approx(24.0)


def test_dirty_eviction_flush_delays_queued_loads():
    """Hand-built mutating trace, capacity 1: the dirty line's flush
    occupies the only disk arm, so the re-load of the evicted object
    stalls for load + residual flush time.

      write a : write-allocate 0->10 (stall 10), dirty, think -> 11
      access b: demand 11->21 (stall 10); inserting b evicts dirty a,
                flush occupies the slot 21->25
      access a: needed at 22, load queues behind the flush 25->35
                (stall 13 = 10 load + 3 residual flush)"""
    store, (a, b) = _store_with(2)
    trace = RecordedTrace("t", "m", [("write", a), ("access", b), ("access", a)], [a, b, a])
    engine = replay_baseline(trace, store, latency=LATW, cache_capacity=1)
    assert engine.writes == 1 and engine.write_hits == 0
    assert engine.dirty_evictions == 1 and engine.flushed_writes == 1
    assert engine.stall_seconds == pytest.approx(33.0)
    assert engine.thrash_misses == 1


def test_write_hit_dirties_without_stalling():
    store, (a,) = _store_with(1)
    trace = RecordedTrace("t", "m", [("access", a), ("write", a)], [a, a])
    engine = replay_baseline(trace, store, latency=LATW)
    # only the cold read stalls; the write finds the line resident
    assert engine.stall_seconds == pytest.approx(10.0)
    assert engine.writes == 1 and engine.write_hits == 1
    assert engine.flushed_writes == 0  # unbounded cache: never evicted


def test_prefetched_write_counts_timely():
    """A write to an object prefetching made resident is a timely hit —
    write-allocate was hidden exactly like a read's demand load."""
    store, (a, b) = _store_with(2)
    trace = RecordedTrace("t", "m",
                          [("enter", "Obj.m", a), ("access", a), ("write", b)], [a, b])
    res = replay(trace, Scripted(on_entry=[b]), store, None, latency=LAT)
    # a: demand 0->10 (stall 10); b: prefetched load done at 10 <= 11
    assert res.stall_seconds == pytest.approx(10.0)
    assert res.timely_coverage == pytest.approx(0.5)
    assert res.writes == 1 and res.write_hits == 1
    assert res.recall == pytest.approx(0.5)  # written oids count as demand


def test_store_write_allocate_and_dirty_accounting():
    """ObjectStore.app_write is a demand access: write-allocate miss,
    dirty bit, accessed_oids, listeners, trace — none of which it used
    to touch."""
    store = ObjectStore(n_services=1)
    ds = store.services[0]
    a = store.put("X", {"v": 1})
    missed, seen = [], []
    store.miss_listener = missed.append
    store.access_listener = seen.append
    store.trace = []
    store.app_write(a)  # uncached: the write performs the disk load
    m = store.metrics
    assert m.writes == 1 and m.write_hits == 0 and m.app_cache_misses == 1
    assert ds.is_cached(a) and a in ds.dirty
    assert a in store.accessed_oids
    assert missed == [a] and seen == [a]
    assert [(e.kind, e.oid) for e in store.trace] == [("write", a)]
    store.app_write(a)  # resident: write hit, no second miss
    assert store.metrics.write_hits == 1 and store.metrics.writes == 2
    assert store.metrics.app_cache_misses == 1
    assert missed == [a] and seen == [a, a]
    ds.drop_cache()  # flushes the dirty line (charges write_back)
    assert ds.flushed_writes == 1 and not ds.dirty
    assert store.metrics.flushed_writes == 1


def test_credit_all_primitive_writes_hit_resident_lines():
    """The write-dense bank traversal: every transaction is navigated and
    then updated in place, so each primitive-field write is a write hit on
    the line the read just loaded — no extra misses, one dirty line per
    transaction."""
    client = POSClient(n_services=2)
    client.register(build_bank_app())
    root = populate_bank_store(client.store, n_transactions=12)
    with client.session("bank", mode=None) as s:
        s.execute(root, "creditAll", 5.0)
    m = client.store.metrics
    assert m.writes == 12 and m.write_hits == 12
    dirty = sum(len(ds.dirty) for ds in client.store.services)
    assert dirty == 12
    txs = client.store.peek(root).fields["transactions"]
    assert all(
        client.store.peek(t).fields["amount"] == pytest.approx(i + 5.0)
        for i, t in enumerate(txs)
    )


def test_store_dirty_eviction_flushes_write_back():
    store = ObjectStore(n_services=1, cache_capacity=1)
    ds = store.services[0]
    a = store.put("X", {})
    b = store.put("X", {})
    store.app_write(a)
    ds.load_into_memory(b)  # evicts dirty a -> flush
    assert ds.evictions == 1
    assert ds.dirty_evictions == 1 and ds.flushed_writes == 1
    assert store.metrics.dirty_evictions == 1 and store.metrics.flushed_writes == 1
    assert a not in ds.dirty


def test_reset_runtime_state_clears_eviction_counters():
    """Regression: DataService.evictions survived reset_runtime_state and
    accumulated across benchmark repetitions."""
    store = ObjectStore(n_services=1, cache_capacity=1)
    ds = store.services[0]
    oids = [store.put("X", {}) for _ in range(3)]
    for o in oids:
        ds.load_into_memory(o)
    assert ds.evictions == 2
    store.reset_runtime_state()
    assert ds.evictions == 0
    assert ds.dirty_evictions == 0 and ds.flushed_writes == 0
    for o in oids:
        ds.load_into_memory(o)
    assert ds.evictions == 2  # fresh count, not 4


def test_second_session_preserves_first_sessions_listeners():
    """Regression: opening (and closing) a second session used to clobber
    the first session's predictor monitoring hooks."""
    client = POSClient(n_services=2)
    client.register(build_bank_app())
    populate_bank_store(client.store, n_transactions=5)
    s1 = client.session("bank", mode="markov-miner")
    miner_listener = client.store.access_listener
    assert miner_listener is not None
    try:
        with client.session("bank", mode=None):
            assert client.store.access_listener is miner_listener
        assert client.store.access_listener is miner_listener
        # a rop session installs only its miss listener, and removes only it
        with client.session("bank", mode="rop"):
            assert client.store.miss_listener is not None
            assert client.store.access_listener is miner_listener
        assert client.store.miss_listener is None
        assert client.store.access_listener is miner_listener
        # a second miner displaces the hook for its lifetime, then restores
        with client.session("bank", mode="markov-miner"):
            assert client.store.access_listener is not miner_listener
        assert client.store.access_listener is miner_listener
    finally:
        s1.close()
    assert client.store.access_listener is None


def test_non_lifo_session_close_never_resurrects_dead_listeners():
    """Closing sessions out of LIFO order must not reinstall a hook whose
    predictor already unbound: a zombie miner listener would keep charging
    monitoring on every access with no session left to remove it."""
    client = POSClient(n_services=2)
    client.register(build_bank_app())
    populate_bank_store(client.store, n_transactions=5)
    s1 = client.session("bank", mode="markov-miner")
    s2 = client.session("bank", mode="markov-miner")
    s1.close()  # s2's hook is installed; s1 removes nothing, restores nothing
    assert client.store.access_listener is not None
    s2.close()  # must NOT restore s1's now-dead hook
    assert client.store.access_listener is None
    assert client.store.miss_listener is None


def test_markov_warm_accepts_event_and_bare_oid_traces():
    from repro_torch.predict.markov import MarkovMiner

    events = [
        TraceEvent("access", 1),
        TraceEvent("method_entry", 1, "X.m"),  # skipped: not a demand event
        TraceEvent("write", 2),  # writes are part of the mined stream
        TraceEvent("access", 3),
    ]
    assert trace_oids(events) == [1, 2, 3]
    m_events, m_oids = MarkovMiner(), MarkovMiner()
    m_events.warm(events)
    m_oids.warm([1, 2, 3])
    assert m_events._table == m_oids._table


def test_bank_write_workload_scores_writes_for_all_predictors():
    """The acceptance bar: the mutating bank traversal is recorded with
    write events and every predictor gets timeliness rows with the write
    path charged."""
    wl = _catalog()["bank_write"]
    results = evaluate_workload(wl, modes=("capre", "markov-miner"), cache_capacities=(64,))
    assert {r.predictor for r in results} == {"static-capre", "markov-miner"}
    for r in results:
        assert r.workload == "setAllTransCustomers"
        assert r.writes > 0  # the setCustomer updates were replayed
        assert r.baseline_stall_seconds > 0
        assert 0.0 <= r.timely_coverage <= 1.0
    by = {r.predictor: r for r in results}
    # method-entry lead hides disk loads on the mutating traversal too
    assert by["static-capre"].stall_seconds < by["static-capre"].baseline_stall_seconds


# ---------------------------------------------------------------------------
# the paper's claim, now measurable
# ---------------------------------------------------------------------------


def test_static_capre_beats_markov_on_timely_coverage_for_collections():
    """Order-aware coverage ties static-capre and the miner (~1.0 both);
    the virtual clock separates them: method-entry lead hides the disk,
    access-chained lead does not (kmeans is the collection-heavy app)."""
    results = {r.predictor: r for r in evaluate_workload(
        _catalog()["kmeans"], modes=("capre", "markov-miner"), cache_capacities=(64,)
    )}
    capre, markov = results["static-capre"], results["markov-miner"]
    assert capre.coverage == pytest.approx(markov.coverage, abs=0.05)  # the old metric ties
    assert capre.timely_coverage > markov.timely_coverage + 0.1  # the new one does not
    assert capre.stall_seconds < markov.stall_seconds


# ---------------------------------------------------------------------------
# parallel recording + artifacts
# ---------------------------------------------------------------------------


def test_record_catalog_matches_serial_recording():
    catalog = _catalog()
    wls = [catalog["bank"], catalog["wordcount"]]
    recorded = record_catalog(wls, runs=1)
    assert set(recorded) == {"bank", "wordcount"}
    _, _, serial = record_workload(catalog["bank"], runs=1)
    _, _, parallel = recorded["bank"]
    assert parallel[0].events == serial[0].events
    assert parallel[0].accesses == serial[0].accesses


def test_write_csv_round_trips_with_nan_safe_cells(tmp_path):
    # kmeans has no single associations: rop emits nothing, so its
    # precision is *undefined* and must land as an empty cell
    wl = _catalog()["kmeans"]
    results = evaluate_workload(wl, modes=("capre", "rop"), cache_capacities=(0,))
    path = write_csv(results, str(tmp_path / "predict" / "replay.csv"))
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2
    assert set(rows[0]) == set(CSV_COLUMNS)
    by_pred = {r["predictor"]: r for r in rows}
    assert float(by_pred["static-capre"]["timely_coverage"]) > 0.9
    assert by_pred["rop"]["precision"] == ""  # undefined, not a phantom 0.0
    assert by_pred["rop"]["evaluated"] == "False"
    assert float(by_pred["rop"]["recall"]) == 0.0  # defined: accesses happened
