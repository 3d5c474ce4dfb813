"""The port's prediction subsystem, held to tests/test_predict.py's claims
at its sizes: registry resolution, the four predictors online (live
Session) and offline (trace replay through ``repro_torch.predict.evaluate``),
trace recording order, accuracy edge cases, and the store's coalescing
fixes.  Every recording runs with the trace cache off.

Left out: the weight streamer's three accounting tests
(tests/test_predict.py:323-387), whose twins are in
tests/test_torch_stream.py.
"""

import threading
import time

import pytest

from repro_torch.apps.bank import build_bank_app, populate_bank_store
from repro_torch.pos.client import POSClient, Session, SessionConfig
from repro_torch.pos.latency import ZERO, LatencyModel
from repro_torch.pos.store import ObjectStore, prefetch_accuracy
from repro_torch import predict
from repro_torch.predict.evaluate import (
    _catalog,
    evaluate_workload,
    record_workload,
    replay,
)


@pytest.fixture()
def client():
    c = POSClient(n_services=4, latency=ZERO)
    c.register(build_bank_app())
    return c


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_registry_exposes_all_four_predictors():
    names = predict.available(kind="pos")
    assert {"static-capre", "rop", "markov-miner", "hybrid"} <= set(names)
    assert set(predict.available(kind="stream")) >= {"static-capre", "rop"}


def test_registry_aliases_keep_historical_mode_strings():
    assert predict.canonical("capre") == "static-capre"
    assert predict.canonical("markov") == "markov-miner"
    assert isinstance(predict.make_pos_predictor("capre"), predict.StaticCapre)


def test_registry_unknown_mode_raises_with_candidates(client):
    with pytest.raises(KeyError, match="static-capre"):
        predict.get("palantir")
    with pytest.raises(KeyError, match="unknown prefetch mode"):
        client.session("bank", mode="nope")


def test_all_registered_modes_run_live(client):
    root = populate_bank_store(client.store, n_transactions=20)
    # warm trace for the miners
    client.store.trace = []
    with client.session("bank", mode=None) as s:
        s.execute(root, "auditAll")
    warm = list(client.store.trace)
    client.store.trace = None
    for mode in predict.available(kind="pos"):
        client.store.reset_runtime_state()
        with client.session("bank", mode=mode, warm_trace=warm) as s:
            s.execute(root, "auditAll")
            assert s.drain(10.0)
        assert client.store.snapshot_metrics()["prefetch_requests"] > 0, mode


# ---------------------------------------------------------------------------
# trace recording
# ---------------------------------------------------------------------------


def test_trace_records_accesses_in_navigation_order(client):
    from repro_torch.pos.trace import trace_oids

    root = populate_bank_store(client.store, n_transactions=10)
    client.store.trace = []
    with client.session("bank", mode=None) as s:
        s.execute(root, "auditAll")
    events = client.store.trace
    # schema v2: typed events — the read-only traversal records accesses
    # and method entries, no writes
    assert {e.kind for e in events} == {"access", "method_entry"}
    trace = trace_oids(events)
    assert trace[0] == root  # the receiver is accessed first
    assert len(trace) == client.store.metrics.app_loads
    assert set(trace) == client.store.accessed_oids
    # auditAll navigates each transaction before its type/emp/account chain
    tx_oids = client.store.peek(root).fields["transactions"]
    first_tx = trace.index(tx_oids[0])
    chain = client.store.peek(tx_oids[0]).fields
    assert trace.index(chain["type"]) > first_tx
    assert trace.index(chain["emp"]) > first_tx
    # the method entry for auditAll is recorded right after the root access
    assert events[1].kind == "method_entry" and events[1].oid == root
    assert events[1].method_key.endswith("auditAll")


def test_trace_reset_and_off_by_default(client):
    root = populate_bank_store(client.store, n_transactions=5)
    assert client.store.trace is None
    with client.session("bank", mode=None) as s:
        s.execute(root, "auditAll")
    assert client.store.trace is None  # never turned on implicitly
    client.store.trace = []
    client.store.reset_runtime_state()
    assert client.store.trace == []  # reset keeps recording enabled


# ---------------------------------------------------------------------------
# accuracy accounting edge cases
# ---------------------------------------------------------------------------


def test_prefetch_accuracy_empty_sets():
    """Nothing prefetched, nothing accessed: both ratios are *undefined*,
    not 0.0 — phantom zeros used to be indistinguishable from a measured
    total miss."""
    acc = prefetch_accuracy(set(), set())
    assert acc["true_positives"] == 0
    assert acc["precision"] is None and acc["recall"] is None
    assert acc["evaluated"] is False


def test_prefetch_accuracy_all_false_positives():
    acc = prefetch_accuracy({1, 2, 3}, set())
    assert acc["false_positives"] == 3
    assert acc["precision"] == 0.0  # defined: 3 emissions, all useless
    assert acc["recall"] is None  # undefined: nothing was ever accessed
    assert acc["evaluated"] is True


def test_prefetch_accuracy_all_false_negatives():
    acc = prefetch_accuracy(set(), {7, 8})
    assert acc["false_negatives"] == 2
    assert acc["recall"] == 0.0  # defined: 2 accesses, none prefetched
    assert acc["precision"] is None  # undefined: the predictor emitted nothing
    assert acc["evaluated"] is False


def test_prefetch_accuracy_mixed_matches_store_method(client):
    client.store.prefetched_oids = {1, 2, 3}
    client.store.accessed_oids = {2, 3, 4}
    acc = client.store.prefetch_accuracy()
    assert acc == prefetch_accuracy({1, 2, 3}, {2, 3, 4})
    assert acc["precision"] == pytest.approx(2 / 3)
    assert acc["recall"] == pytest.approx(2 / 3)


# ---------------------------------------------------------------------------
# offline replay harness
# ---------------------------------------------------------------------------


def test_recorded_trace_roundtrips_through_replay():
    wl = _catalog()["bank"]
    client, root, traces = record_workload(wl, runs=2)
    train, eval_ = traces
    # deterministic read-only traversal: both runs record identical streams
    assert train.events == eval_.events
    assert train.accesses[0] == root
    assert [e.oid for e in eval_.events if e.kind in ("access", "write")] == eval_.accesses
    reg = client.logic_module.registered["bank"]
    # static replay of the recorded trace reaches the live session's recall
    res = replay(eval_, predict.make_pos_predictor("capre"), client.store, reg)
    assert res.recall >= 0.99
    assert res.true_positives + res.false_negatives == len(set(eval_.accesses))


def test_offline_replay_matches_live_accuracy_for_capre(client):
    """The replay harness and the live store agree on CAPre's accuracy for
    the same deterministic workload."""
    wl = _catalog()["bank"]
    client2, root, traces = record_workload(wl, runs=1)
    reg = client2.logic_module.registered["bank"]
    offline = replay(traces[0], predict.make_pos_predictor("capre"), client2.store, reg)
    client2.store.reset_runtime_state()
    with Session(client2.store, reg, SessionConfig(mode="capre")) as s:
        s.execute(root, "auditAll")
        assert s.drain(10.0)
    live = client2.store.prefetch_accuracy()
    assert offline.recall == pytest.approx(live["recall"], abs=0.02)


def test_markov_beats_rop_recall_on_collection_workload():
    """K-Means has no single associations: ROP predicts nothing while the
    trace miner reconstructs the access sequence (the acceptance bar)."""
    results = {r.predictor: r for r in evaluate_workload(
        _catalog()["kmeans"], modes=("rop", "markov-miner"), rop_depth=5
    )}
    assert results["rop"].recall == 0.0
    assert results["markov-miner"].recall > 0.9
    assert results["markov-miner"].recall > results["rop"].recall
    # and the miner paid for it: table memory + monitored events
    assert results["markov-miner"].overhead["table_bytes"] > 0
    assert results["markov-miner"].overhead["monitor_events"] > 0
    assert results["rop"].overhead["table_bytes"] == 0


def test_static_capre_charges_zero_monitoring():
    results = {r.predictor: r for r in evaluate_workload(
        _catalog()["bank"], modes=("capre", "markov-miner")
    )}
    assert results["static-capre"].overhead["monitor_events"] == 0
    assert results["markov-miner"].overhead["monitor_events"] > 0
    assert results["static-capre"].recall >= 0.99


def test_evaluate_apps_covers_three_benchmarks():
    from repro_torch.predict.evaluate import evaluate_apps, format_table

    results = evaluate_apps(apps=("bank", "wordcount", "kmeans"),
                            modes=("capre", "rop", "markov-miner", "hybrid"),
                            trace_cache=None)
    assert len(results) == 12
    table = format_table(results)
    assert "wordcount" in table and "hybrid" in table and "recall" in table


# ---------------------------------------------------------------------------
# live markov session (online monitoring path)
# ---------------------------------------------------------------------------


def test_live_markov_session_prefetches_after_warm(client):
    root = populate_bank_store(client.store, n_transactions=30)
    client.store.trace = []
    with client.session("bank", mode=None) as s:
        s.execute(root, "auditAll")
    warm = list(client.store.trace)
    client.store.trace = None
    client.store.reset_runtime_state()
    with client.session("bank", mode="markov-miner", warm_trace=warm) as s:
        s.execute(root, "auditAll")
        assert s.drain(10.0)
        overhead = s.predictor.overhead
    acc = client.store.prefetch_accuracy()
    assert acc["recall"] > 0.9
    assert overhead.monitor_events == client.store.metrics.app_loads
    assert overhead.table_bytes > 0
    # listeners are removed on close
    assert client.store.access_listener is None


def test_live_hybrid_covers_collections_and_singles(client):
    root = populate_bank_store(client.store, n_transactions=30)
    client.store.trace = []
    with client.session("bank", mode=None) as s:
        s.execute(root, "auditAll")
    warm = list(client.store.trace)
    client.store.trace = None
    client.store.reset_runtime_state()
    with client.session("bank", mode="hybrid", warm_trace=warm) as s:
        s.execute(root, "auditAll")
        assert s.drain(10.0)
    acc = client.store.prefetch_accuracy()
    assert acc["recall"] > 0.95


# ---------------------------------------------------------------------------
# DataService coalescing fixes (satellite)
# ---------------------------------------------------------------------------


def test_waiter_recovers_when_owner_never_lands_the_load():
    """A pre-set in-flight event whose owner never cached the object must
    not satisfy a waiter: it re-takes ownership and performs the load."""
    store = ObjectStore(n_services=1, latency=ZERO)
    ds = store.services[0]
    a = store.put("X", {})
    ev = threading.Event()
    ev.set()
    ds._inflight[a] = ev  # owner died after signalling, before landing
    assert ds.load_into_memory(a) is True
    assert ds.is_cached(a)
    assert a not in ds._inflight


def test_coalesced_waiter_gets_lru_bump():
    """The waiter's access counts for LRU recency: after waking it must
    bump the object it waited for, not leave it at the owner's position."""
    store = ObjectStore(n_services=1, latency=ZERO, cache_capacity=3)
    ds = store.services[0]
    a, b, c, d = [store.put("X", {}) for _ in range(4)]
    ev = threading.Event()
    ds._inflight[a] = ev
    result = []
    waiter = threading.Thread(target=lambda: result.append(ds.load_into_memory(a)))
    waiter.start()
    time.sleep(0.05)  # waiter is parked on the in-flight event
    with ds._cache_lock:
        ds._touch(a)  # the "owner's" load lands: a is oldest…
    ds.load_into_memory(b)
    ds.load_into_memory(c)  # …after b and c load: LRU order a, b, c
    ev.set()
    waiter.join(timeout=5.0)
    assert result == [False]  # coalesced, no second disk load
    ds.load_into_memory(d)  # one eviction: the waiter's bump saves a
    assert ds.is_cached(a)
    assert not ds.is_cached(b)


def test_coalescing_still_single_loads_under_concurrency():
    lat = LatencyModel(disk_load=20e-3, remote_hop=0.0, write_back=0.0, think=0.0)
    store = ObjectStore(n_services=1, latency=lat)
    ds = store.services[0]
    a = store.put("X", {})
    results = []
    threads = [
        threading.Thread(target=lambda: results.append(ds.load_into_memory(a)))
        for _ in range(4)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=5.0)
    assert sorted(results) == [False, False, False, True]
    assert ds.is_cached(a)
