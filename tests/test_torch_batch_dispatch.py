"""The port's batched, placement-aware prefetch dispatch, held to
tests/test_batch_dispatch.py's claims at its sizes: per-oid vs batch
equivalence on the live store (every eviction policy, per service and
under a shared budget), predispatch dedupe accounting, the virtual-clock
mirror (``VirtualDisk.schedule_batch`` and ``VirtualReplay``'s dispatch
modes), the static optimizer's signals through dispatch, the drain-leak
fix (warn + hard drain) and trace memoization (in ``tmp_path`` only).

Left out:

* the calibration-fit test of ``benchmarks/calibrate_latency.py``
  (tests/test_batch_dispatch.py:548), which the port does not carry;
* the weight streamer's group-batch test
  (tests/test_batch_dispatch.py:581), whose twin is in
  tests/test_torch_stream.py.

The policy matrix honors ``CAPRE_TEST_POLICIES`` like the eviction suite.
"""

import os
import threading
import warnings

import pytest

from repro_torch.apps.bank import build_bank_app, populate_bank_store
from repro_torch.pos.client import POSClient
from repro_torch.pos.eviction import POLICIES
from repro_torch.pos.executor import PrefetchRuntime
from repro_torch.pos.latency import ZERO, LatencyModel, VirtualDisk
from repro_torch.pos.store import ObjectStore
from repro_torch.predict.evaluate import (
    RecordedTrace,
    VirtualReplay,
    _catalog,
    record_workload,
    replay,
)

TEST_POLICIES = tuple(
    p for p in os.environ.get("CAPRE_TEST_POLICIES", ",".join(POLICIES)).split(",") if p
)


# ---------------------------------------------------------------------------
# live-store equivalence: batch == per-oid where it must
# ---------------------------------------------------------------------------


def _run_live(dispatch, mode, capacity=0, policy="lru", shared=False, workload="auditAll"):
    client = POSClient(n_services=4, latency=ZERO, cache_capacity=capacity,
                       cache_policy=policy, shared_budget=shared)
    client.register(build_bank_app())
    root = populate_bank_store(client.store, n_transactions=40)
    warm_trace = None
    if mode in ("markov-miner", "hybrid"):
        client.store.trace = []
        with client.session("bank", mode=None) as s:
            s.execute(root, workload)
        warm_trace = list(client.store.trace)
        client.store.trace = None
        client.store.reset_runtime_state()
    with client.session("bank", mode=mode, dispatch=dispatch,
                        warm_trace=warm_trace) as s:
        s.execute(root, workload)
        assert s.drain(15.0)
    acc = client.store.prefetch_accuracy()
    return sorted(client.store.prefetched_oids), acc, client.store.snapshot_metrics()


@pytest.mark.parametrize("policy", TEST_POLICIES)
@pytest.mark.parametrize("shared", [False, True])
def test_batch_dispatch_identical_prefetched_set_per_policy(policy, shared):
    """At ZERO latency the batched dispatcher must prefetch byte-identical
    oid sets (and therefore identical accuracy) to the per-oid dispatcher,
    for every eviction policy, per-service and under a shared budget."""
    per_oid = _run_live("per-oid", "capre", capacity=32, policy=policy, shared=shared)
    batch = _run_live("batch", "capre", capacity=32, policy=policy, shared=shared)
    assert per_oid[0] == batch[0]
    assert per_oid[1] == batch[1]


# rop is excluded: its emissions are miss-driven, and which accesses miss
# depends on how fast earlier prefetches land — a feedback loop through the
# cache that is timing-dependent under EITHER dispatch mode.  The replay
# equivalence test below proves the dispatch layer itself is equivalent
# given identical emissions; the live test covers the predictors whose
# emission stream is deterministic.
@pytest.mark.parametrize("mode", ["capre", "markov-miner", "hybrid"])
def test_batch_dispatch_identical_accuracy_all_predictors(mode):
    per_oid = _run_live("per-oid", mode)
    batch = _run_live("batch", mode)
    assert per_oid[0] == batch[0], mode
    assert per_oid[1] == batch[1], mode
    # the batched dispatcher may REQUEST fewer oids (capre prunes
    # re-expansion of already-dispatched hint subtrees) but never more
    assert per_oid[2]["prefetch_requests"] >= batch[2]["prefetch_requests"], mode


def test_batch_dispatch_collapses_submission_count():
    _oids, _acc, metrics = _run_live("batch", "capre")
    per_oid_metrics = _run_live("per-oid", "capre")[2]
    # one injected method entry -> at most one batch task per Data Service
    # per streamed segment; the per-oid dispatcher paid one submission per
    # predicted oid (an order of magnitude more)
    n_seg = -(-per_oid_metrics["prefetch_requests"] // 64)  # StaticCapre.SEGMENT
    assert metrics["batch_dispatches"] <= 4 * n_seg
    assert per_oid_metrics["batch_dispatches"] == per_oid_metrics["prefetch_requests"]
    assert metrics["batch_dispatches"] * 5 < per_oid_metrics["batch_dispatches"]


def test_unknown_dispatch_mode_rejected():
    client = POSClient(n_services=1, latency=ZERO)
    client.register(build_bank_app())
    with pytest.raises(ValueError, match="unknown dispatch mode"):
        client.session("bank", mode="capre", dispatch="bogus")


# ---------------------------------------------------------------------------
# predispatch dedupe: cached and in-flight oids are suppressed but counted
# ---------------------------------------------------------------------------


def test_prefetch_batch_suppresses_cached_and_inflight():
    store = ObjectStore(n_services=1, latency=ZERO)
    ds = store.services[0]
    cached, inflight, fresh = (store.put("X", {}) for _ in range(3))
    ds.load_into_memory(cached)
    ev = threading.Event()
    ds._inflight[inflight] = ev  # a load someone else owns
    submitted = store.prefetch_batch([cached, inflight, fresh, fresh])
    ev.set()
    assert submitted == 1
    assert ds.dedup_suppressed == 3  # cached + in-flight + duplicate
    assert ds.prefetch_requests == 4
    assert ds.batch_dispatches == 1
    assert ds.prefetch_loads == 1  # only the fresh oid hit the disk
    assert ds.is_cached(fresh)
    # accuracy accounting still records every requested oid (what the
    # per-oid path reported): suppression is a dispatch optimization
    assert store.prefetched_oids == {cached, inflight, fresh}


def test_prefetch_batch_all_suppressed_submits_nothing():
    store = ObjectStore(n_services=1, latency=ZERO)
    ds = store.services[0]
    oids = [store.put("X", {}) for _ in range(3)]
    for o in oids:
        ds.load_into_memory(o)
    assert store.prefetch_batch(oids) == 0
    assert ds.batch_dispatches == 0
    assert ds.dedup_suppressed == 3
    assert ds.prefetch_loads == 0


def test_load_batch_skips_oids_that_landed_since_the_snapshot():
    store = ObjectStore(n_services=1, latency=ZERO)
    ds = store.services[0]
    a, b = store.put("X", {}), store.put("X", {})
    todo = ds.claim_prefetch_batch([a, b])
    assert todo == [a, b]
    ds.load_into_memory(a)  # a demand load wins the race
    ds.load_batch(todo)
    assert ds.is_cached(a) and ds.is_cached(b)
    assert ds.prefetch_loads == 1  # only b was loaded by the batch


# ---------------------------------------------------------------------------
# virtual-clock mirror
# ---------------------------------------------------------------------------

LAT = LatencyModel(disk_load=10.0, remote_hop=0.0, write_back=0.0, think=1.0,
                   parallel_per_ds=2)


def test_virtual_disk_schedule_batch_matches_serial_schedules():
    a, b = VirtualDisk(LAT), VirtualDisk(LAT)
    batch = a.schedule_batch(0.0, 4)
    serial = [b.schedule(0.0) for _ in range(4)]
    assert batch == serial
    assert a.loads == b.loads == 4


def _store_with(n_objects, n_services=2):
    store = ObjectStore(n_services=n_services)
    return store, [store.put("Obj", {}) for _ in range(n_objects)]


def test_replay_batch_dispatch_equivalent_at_zero_overhead():
    """With dispatch_overhead=0 the two replay modes produce identical
    timeliness (the slot arithmetic is the same); only the dispatch
    counters differ."""
    store, oids = _store_with(8)
    events = [("enter", "Obj.m", oids[0])] + [("access", o) for o in oids]
    trace = RecordedTrace("t", "m", events, list(oids))
    results = {}

    # a scripted predictor emitting everything at method entry
    from repro_torch.predict.base import Predictor

    class Scripted(Predictor):
        name = "scripted"

        def on_method_entry(self, method_key, this_oid):
            return self._emit(list(oids))

    for dispatch in ("per-oid", "batch"):
        results[dispatch] = replay(trace, Scripted(), store, None,
                                   latency=LAT, dispatch=dispatch)
    per_oid, batch = results["per-oid"], results["batch"]
    assert per_oid.stall_seconds == batch.stall_seconds
    assert per_oid.timely_coverage == batch.timely_coverage
    assert per_oid.recall == batch.recall == 1.0
    # per-oid: one submission per emitted oid; batch: one per Data Service
    assert per_oid.batch_dispatches == len(oids)
    assert batch.batch_dispatches == 2  # two services hold the 8 oids
    assert batch.dedup_suppressed == 0
    assert per_oid.dispatch == "per-oid" and batch.dispatch == "batch"


def test_replay_per_oid_dispatch_overhead_delays_issue():
    """With a dispatch_overhead as large as a disk load, per-oid dispatch
    issues late loads so much later that timeliness collapses, while the
    batched dispatcher pays one overhead for the whole batch."""
    lat = LatencyModel(disk_load=10.0, remote_hop=0.0, write_back=0.0, think=1.0,
                      parallel_per_ds=2, dispatch_overhead=10.0)
    store, oids = _store_with(6, n_services=1)
    events = [("enter", "Obj.m", oids[0])] + [("access", o) for o in oids]
    trace = RecordedTrace("t", "m", events, list(oids))

    from repro_torch.predict.base import Predictor

    class Scripted(Predictor):
        name = "scripted"

        def on_method_entry(self, method_key, this_oid):
            return self._emit(list(oids))

    per_oid = replay(trace, Scripted(), store, None, latency=lat, dispatch="per-oid")
    batch = replay(trace, Scripted(), store, None, latency=lat, dispatch="batch")
    assert batch.stall_seconds < per_oid.stall_seconds
    assert batch.timely_coverage >= per_oid.timely_coverage
    assert batch.batch_dispatches == 1


def test_replay_batch_counts_dedup_suppression():
    store, (a, b) = _store_with(2, n_services=1)
    engine = VirtualReplay(store, latency=LAT, dispatch="batch")
    engine.access(a)  # a is now resident (demand)
    engine.predict([a, b, b])  # a cached, b fresh, b duplicate
    assert engine.dedup_suppressed == 2
    assert engine.batch_dispatches == 1
    assert engine.prefetch_loads == 1


# ---------------------------------------------------------------------------
# static-optimizer signals through dispatch: RFO, truncation,
# priority ordering, admission control, modeled executor saturation
# ---------------------------------------------------------------------------


def _live_write_run(dispatch, rfo=True):
    client = POSClient(n_services=4, latency=ZERO)
    client.register(build_bank_app())
    root = populate_bank_store(client.store, n_transactions=40)
    with client.session("bank", mode="capre", dispatch=dispatch, rfo=rfo) as s:
        # fire the hint dispatch directly, with no demand accesses racing
        # the pool (executing the method at any latency makes who-loads-
        # first a scheduling race): every prefetch actually loads, so RFO
        # landings are exact
        s.predictor.on_method_entry("BankManagement.setAllTransCustomers", root)
        assert s.drain(15.0)
    return sorted(client.store.prefetched_oids), client.store.snapshot_metrics()


@pytest.mark.parametrize("dispatch", ["per-oid", "batch"])
def test_live_rfo_prefetches_dirty_allocate(dispatch):
    """Both live dispatch modes honor the hint RFO marks: prefetched update
    sites land dirty, and the counter flows into snapshot_metrics."""
    oids, metrics = _live_write_run(dispatch)
    assert metrics["prefetch_loads"] > 0
    assert metrics["rfo_prefetches"] > 0
    # RFO marks never change the emitted oid set itself: both modes still
    # request byte-identical prefetch sets.  Compared on the direct hint
    # dispatch above — running the full mutating workload live and
    # comparing two runs' sets is a scheduling race (the app's writes to
    # trans.cust race the expansion's field reads, so under CPU contention
    # the two runs legitimately expand different customers)
    other = "batch" if dispatch == "per-oid" else "per-oid"
    assert oids == _live_write_run(other)[0]


def test_live_rfo_disabled_by_session_config():
    _oids, metrics = _live_write_run("batch", rfo=False)
    assert metrics["prefetch_loads"] > 0
    assert metrics["rfo_prefetches"] == 0


def test_replay_rfo_equivalent_across_dispatch_modes():
    """Identical emissions + identical RFO marks -> identical stall and RFO
    accounting in both virtual dispatch modes."""
    store, oids = _store_with(8)
    events = ([("enter", "Obj.m", oids[0])] + [("access", o) for o in oids]
              + [("write", o) for o in oids])
    trace = RecordedTrace("t", "m", events, list(oids))

    from repro_torch.predict.base import Predictor

    class Scripted(Predictor):
        name = "scripted"

        def on_method_entry(self, method_key, this_oid):
            return self._emit(list(oids), rfo=frozenset(oids),
                              priorities={o: 0.5 for o in oids})

    results = {d: replay(trace, Scripted(), store, None, latency=LAT, dispatch=d)
               for d in ("per-oid", "batch")}
    per_oid, batch = results["per-oid"], results["batch"]
    assert per_oid.stall_seconds == batch.stall_seconds
    r_per, r_batch = per_oid.row(), batch.row()
    assert r_per["rfo_prefetches"] == r_batch["rfo_prefetches"] == len(oids)
    # every write hit a dirty-allocated line: no ownership upgrades at all
    assert r_per["ownership_upgrades"] == r_batch["ownership_upgrades"] == 0
    assert r_per["hint_priority_mean"] == r_batch["hint_priority_mean"] == 0.5


def test_replay_rfo_off_pays_ownership_upgrades():
    """The A/B control: same trace, rfo disabled -> prefetches land clean
    and every write to a clean resident line pays the upgrade round trip."""
    lat = LatencyModel(disk_load=10.0, remote_hop=1.0, write_back=0.0,
                       think=0.1, parallel_per_ds=2)
    store, oids = _store_with(6, n_services=1)
    events = ([("enter", "Obj.m", oids[0])] + [("access", o) for o in oids]
              + [("write", o) for o in oids])
    trace = RecordedTrace("t", "m", events, list(oids))

    from repro_torch.predict.base import Predictor

    def scripted():
        class Scripted(Predictor):
            name = "scripted"

            def on_method_entry(self, method_key, this_oid):
                return self._emit(list(oids), rfo=frozenset(oids))

        return Scripted()

    on = replay(trace, scripted(), store, None, latency=lat, rfo=True)
    off = replay(trace, scripted(), store, None, latency=lat, rfo=False)
    assert on.row()["rfo_prefetches"] == len(oids)
    assert off.row()["rfo_prefetches"] == 0
    assert off.row()["ownership_upgrades"] == len(oids)
    assert on.row()["ownership_upgrades"] == 0
    expect = len(oids) * lat.remote_hop
    assert off.stall_seconds - on.stall_seconds == pytest.approx(expect)


def test_bank_write_rfo_improves_calibrated_stall():
    """The acceptance criterion end to end: on the recorded mutating bank
    traversal, static-capre with RFO strictly beats RFO-off on stall."""
    wl = _catalog()["bank_write"]
    rows = {}
    for rfo in (True, False):
        client, _root, traces = record_workload(wl, runs=2)
        reg = client.logic_module.registered[wl.name]
        from repro_torch.predict import make_pos_predictor

        predictor = make_pos_predictor("static-capre")
        predictor.warm(traces[0].accesses)
        rows[rfo] = replay(traces[-1], predictor, client.store, reg,
                           dispatch="batch", rfo=rfo)
    assert rows[True].row()["rfo_prefetches"] > 0
    assert rows[False].row()["ownership_upgrades"] > 0
    assert rows[True].stall_seconds < rows[False].stall_seconds


def test_iter_hint_tree_truncates_to_prefix_bound():
    """Partial-traversal truncation in the offline expander: the early-exit
    scan's hint expands only the static prefix of the collection."""
    from repro_torch.core.opt import DEFAULT_PREFIX_BOUND
    from repro_torch.predict.static_capre import StaticCapre

    wl = _catalog()["bank"]
    client, root, _traces = record_workload(wl, runs=1)
    reg = client.logic_module.registered["bank"]
    predictor = StaticCapre()
    predictor.attach(client.store, reg)
    out = predictor.on_method_entry("BankManagement.findLargeTransaction", root)
    # root + bounded prefix of transactions + their account.cust chains
    n_trans = sum(1 for o in out
                  if client.store.peek(o) and client.store.cls_of(o) == "Transaction")
    assert n_trans == DEFAULT_PREFIX_BOUND  # 40 transactions exist
    assert predictor.overhead.truncated_hints > 0
    # the full-traversal workload is NOT truncated
    p2 = StaticCapre()
    p2.attach(client.store, reg)
    out_full = p2.on_method_entry("BankManagement.auditAll", root)
    assert p2.overhead.truncated_hints == 0
    assert len(out_full) > len(out)


def test_replay_priority_orders_batches_and_admission_sheds():
    """PrefetchRuntime.admit: headroom admits everything; at the cap only
    priorities clearing the threshold get in."""
    rt = PrefetchRuntime(parallel_workers=1, max_outstanding=0)
    assert rt.admit(0.0)  # disabled: never sheds
    rt2 = PrefetchRuntime(parallel_workers=1, max_outstanding=1,
                          admission_threshold=0.5)
    release = threading.Event()
    rt2.fan_out(lambda _i: release.wait(10.0), [0])  # 1 outstanding = cap
    assert rt2.admit(0.9)       # above threshold: admitted even at cap
    assert not rt2.admit(0.1)   # below: shed
    assert rt2.admission_dropped == 1
    release.set()
    assert rt2.drain(5.0)
    rt.shutdown()
    rt2.shutdown()


def test_live_admission_control_sheds_low_priority_batches():
    store = ObjectStore(n_services=1, latency=ZERO)
    rt = PrefetchRuntime(parallel_workers=1, max_outstanding=1,
                         admission_threshold=0.5)
    release = threading.Event()
    rt.fan_out(lambda _i: release.wait(10.0), [0])
    oids = [store.put("X", {}) for _ in range(3)]
    n = store.prefetch_batch(oids, runtime=rt,
                             priorities={o: 0.1 for o in oids})
    assert n == 0  # the whole batch was shed
    assert rt.admission_dropped == 1
    n2 = store.prefetch_batch(oids, runtime=rt,
                              priorities={o: 0.9 for o in oids})
    assert n2 == 1
    release.set()
    assert rt.drain(5.0)
    rt.shutdown()


def test_virtual_executor_slots_saturate():
    """The modeled dispatch pool: with one slot, per-oid issues serialize
    behind each other's loads; with ample slots they overlap."""
    lat = LatencyModel(disk_load=10.0, remote_hop=0.0, write_back=0.0,
                       think=1.0, parallel_per_ds=8)
    store, oids = _store_with(4, n_services=1)
    narrow = VirtualReplay(store, latency=lat, executor_workers=1)
    narrow.predict(list(oids))
    assert narrow.exec_delayed == len(oids) - 1
    wide = VirtualReplay(store, latency=lat, executor_workers=8)
    wide.predict(list(oids))
    assert wide.exec_delayed == 0
    # serialized issue pushes each later load's completion out by a full
    # service time relative to the wide pool
    t_narrow = max(done for _s, done in narrow.inflight[0].values())
    t_wide = max(done for _s, done in wide.inflight[0].values())
    assert t_narrow > t_wide


# ---------------------------------------------------------------------------
# drain-leak regression (satellite): warn + hard drain
# ---------------------------------------------------------------------------


def test_hard_drain_cancels_queued_stragglers():
    rt = PrefetchRuntime(parallel_workers=1)
    release = threading.Event()
    ran = []
    rt.fan_out(lambda _i: release.wait(20.0), [0])  # occupies the only worker
    rt.fan_out(ran.append, range(5))  # queued behind it
    assert not rt.drain(0.2)
    assert not rt.hard_drain(0.2)  # cancels the queued 5; blocker still runs
    release.set()
    assert rt.drain(5.0)
    assert ran == []  # cancelled tasks never executed
    rt.shutdown()


def test_reset_runtime_state_warns_and_hard_drains_stragglers():
    store = ObjectStore(n_services=1, latency=ZERO)
    rt = PrefetchRuntime(parallel_workers=1)
    store.register_runtime(rt)
    release = threading.Event()
    oid = store.put("X", {})
    rt.fan_out(lambda _i: release.wait(20.0), [0])
    rt.fan_out(lambda _i: store.prefetch_access(oid), [0])  # would pollute
    with pytest.warns(RuntimeWarning, match="hard-draining"):
        store.reset_runtime_state(drain_timeout=0.2)
    release.set()
    assert rt.drain(5.0)
    # the straggler prefetch was cancelled: the fresh rep's state is clean
    assert store.prefetched_oids == set()
    assert store.snapshot_metrics()["prefetch_requests"] == 0
    rt.shutdown()
    store.unregister_runtime(rt)


def test_reset_runtime_state_quiet_when_idle():
    store = ObjectStore(n_services=1, latency=ZERO)
    rt = PrefetchRuntime(parallel_workers=1)
    store.register_runtime(rt)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        store.reset_runtime_state()
    rt.shutdown()


def test_session_close_unregisters_runtime():
    client = POSClient(n_services=1, latency=ZERO)
    client.register(build_bank_app())
    with client.session("bank", mode=None) as s:
        assert s.runtime in client.store._runtimes
    assert s.runtime not in client.store._runtimes


# ---------------------------------------------------------------------------
# trace memoization (satellite)
# ---------------------------------------------------------------------------


def test_trace_cache_round_trips_and_skips_reexecution(tmp_path):
    wl = _catalog()["bank_write"]  # mutating: store state must round-trip too
    cache = str(tmp_path / "traces")
    c1, root1, t1 = record_workload(wl, runs=2, cache_dir=cache)
    files = os.listdir(cache)
    assert len(files) == 1 and files[0].endswith(".json")
    c2, root2, t2 = record_workload(wl, runs=2, cache_dir=cache)
    assert root1 == root2
    assert [t.events for t in t1] == [t.events for t in t2]
    assert [t.accesses for t in t1] == [t.accesses for t in t2]
    # the cached store snapshot restores the post-recording (warm) state
    for ds1, ds2 in zip(c1.store.services, c2.store.services):
        assert {o: (r.cls, r.fields) for o, r in ds1.disk.items()} == \
               {o: (r.cls, r.fields) for o, r in ds2.disk.items()}


def test_trace_cache_invalidated_by_fingerprint_mismatch(tmp_path):
    import json

    wl = _catalog()["bank"]
    cache = str(tmp_path / "traces")
    _c, _root, t1 = record_workload(wl, runs=1, cache_dir=cache)
    path = os.path.join(cache, os.listdir(cache)[0])
    blob = json.load(open(path))
    blob["fingerprint"]["n_objects"] += 1  # simulate an app/populate change
    json.dump(blob, open(path, "w"))
    before = os.path.getmtime(path)
    _c, _root, t2 = record_workload(wl, runs=1, cache_dir=cache)
    assert [t.events for t in t1] == [t.events for t in t2]  # re-recorded
    assert os.path.getmtime(path) >= before  # entry was rewritten
