"""The port's persistent object store (``repro_torch.pos``) executing the
benchmark apps, against the JAX package's, on the CPU.

Twins of tests/test_trace_schema.py, tests/test_pos_execution.py (all but
its wall-clock test: a timing assertion under parallel test workers is
flaky; ``chip_smoke.py``'s ``[pos]`` phase prints those times instead),
tests/test_cache_eviction.py and tests/test_benchmark_apps.py, at their
sizes and seeds; where a run is deterministic (prefetch off, or the
offline parts) the port's result is also held against JAX's.  Then the
committed traces ``artifacts/predict/traces/{bank,kmeans,wordcount}
_r2_ds4_v2.2.json`` reproduced exactly, the six catalog workloads recorded
equal to JAX's (events, ``snapshot_metrics``, the store after the runs,
the put log), and a ``Session`` in every registered mode.  Online
prefetching races the application on threads, so which oids land as
prefetched differs from run to run: those runs are held to the JAX tests'
own assertions, and to a final store equal to the one of prefetch off;
the one JAX assertion that the race decides (ROP's landed coverage
growing with its depth) is held offline instead, where it is
deterministic.
"""

import heapq
import json
from collections import Counter

import pytest

from repro.apps import bank as jbank
from repro.apps import oo7 as joo7
from repro.apps import pga as jpga
from repro.apps import wordcount as jwordcount
from repro.pos.client import POSClient as JPOSClient
from repro.predict import available as javailable
from repro.predict.evaluate import _catalog as jcatalog
from repro.predict.evaluate import record_workload as jrecord_workload
from repro_torch import predict
from repro_torch.apps.bank import build_bank_app, populate_bank_store
from repro_torch.apps.kmeans import _nearest, build_kmeans_app, initial_centroids, populate_kmeans
from repro_torch.apps.oo7 import build_oo7_app, populate_oo7
from repro_torch.apps.pga import build_pga_app, populate_pga
from repro_torch.apps.wordcount import build_wordcount_app, populate_wordcount
from repro_torch.core.hints import analyze_application
from repro_torch.core.rop import rop_hints
from repro_torch.pos.client import POSClient
from repro_torch.pos.latency import ZERO, LatencyModel
from repro_torch.pos.store import ObjectStore
from repro_torch.pos.trace import (
    ACCESS,
    DEMAND_KINDS,
    METHOD_ENTRY,
    WRITE,
    TraceEvent,
    access_event,
    as_events,
    method_entry_event,
    trace_oids,
    write_event,
)
from torch_pos_canon import (
    CATALOG,
    GOLDEN,
    events,
    fingerprint,
    golden,
    put_log,
    record,
    replay_offline,
    store_dump,
)

# ---------------------------------------------------------------------------
# twins of tests/test_trace_schema.py
# ---------------------------------------------------------------------------

MIXED = [
    method_entry_event("Bank.auditAll", 1),
    access_event(2),
    write_event(3),
    access_event(2),
    method_entry_event("Account.getCustomer", 4),
    write_event(5),
]


def test_event_constructors_and_kinds():
    assert access_event(7) == TraceEvent(ACCESS, 7)
    assert write_event(7) == TraceEvent(WRITE, 7)
    assert method_entry_event("C.m", 7) == TraceEvent(METHOD_ENTRY, 7, "C.m")
    assert access_event(7).is_demand and write_event(7).is_demand
    assert not method_entry_event("C.m", 7).is_demand
    assert set(DEMAND_KINDS) == {ACCESS, WRITE}


def test_to_tuple_round_trips_every_kind():
    wire = [ev.to_tuple() for ev in MIXED]
    assert wire[0] == (METHOD_ENTRY, "Bank.auditAll", 1)
    assert wire[1] == (ACCESS, 2)
    assert wire[2] == (WRITE, 3)
    assert as_events(wire) == MIXED


def test_to_tuple_survives_json():
    wire = json.loads(json.dumps([ev.to_tuple() for ev in MIXED]))
    assert as_events([tuple(item) for item in wire]) == MIXED


def test_as_events_accepts_legacy_enter_tuples():
    legacy = [("enter", "Bank.auditAll", 1), ("access", 2), ("write", 3)]
    assert as_events(legacy) == [
        TraceEvent(METHOD_ENTRY, 1, "Bank.auditAll"),
        TraceEvent(ACCESS, 2),
        TraceEvent(WRITE, 3),
    ]


def test_as_events_accepts_v1_bare_oid_traces():
    assert as_events([5, 6, 5]) == [
        TraceEvent(ACCESS, 5),
        TraceEvent(ACCESS, 6),
        TraceEvent(ACCESS, 5),
    ]


def test_as_events_passes_through_records_and_rejects_junk():
    assert as_events(MIXED) == MIXED
    with pytest.raises(TypeError):
        as_events([("frobnicate", 1)])
    with pytest.raises(TypeError):
        as_events([2.5])


def test_trace_oids_demand_kinds_and_filters():
    assert trace_oids(MIXED) == [2, 3, 2, 5]
    assert trace_oids(MIXED, kinds=(ACCESS,)) == [2, 2]
    assert trace_oids(MIXED, kinds=(WRITE,)) == [3, 5]
    assert trace_oids(MIXED, kinds=(METHOD_ENTRY,)) == [1, 4]
    assert trace_oids([9, 8, 9]) == [9, 8, 9]
    assert trace_oids([ev.to_tuple() for ev in MIXED]) == [2, 3, 2, 5]


def test_recorded_store_trace_round_trips_through_wire_form():
    store = ObjectStore(n_services=2)
    a, b = store.put("X", {}), store.put("X", {})
    store.trace = []
    store.app_access(None, a)
    store.trace_method_entry("X.m", a)
    store.app_write(b)
    recorded = list(store.trace)
    assert [e.kind for e in recorded] == [ACCESS, METHOD_ENTRY, WRITE]
    assert as_events([e.to_tuple() for e in recorded]) == recorded
    assert trace_oids(recorded) == [a, b]


# ---------------------------------------------------------------------------
# twins of tests/test_pos_execution.py
# ---------------------------------------------------------------------------


def _client(app=None, pkg_client=POSClient):
    c = pkg_client(n_services=4, latency=ZERO)
    c.register(app if app is not None else build_bank_app())
    return c


def _run(client, mode=None, rop_depth=1, n_tx=60, populate=populate_bank_store):
    root = populate(client.store, n_transactions=n_tx)
    with client.session("bank", mode=mode, rop_depth=rop_depth) as s:
        s.execute(root, "setAllTransCustomers")
        assert s.drain(10.0)
    return root


def test_execution_semantics_updates_customers():
    client = _client()
    root = _run(client, mode=None)
    store = client.store
    mgr = store.peek(root).fields["manager"]
    mgr_co = store.peek(mgr).fields["company"]
    for tx in store.peek(root).fields["transactions"]:
        acct = store.peek(store.peek(tx).fields["account"])
        cust = store.peek(acct.fields["cust"])
        if cust.fields["company"] == mgr_co:
            assert acct.fields["cust"] == mgr or cust.fields["name"] == "manager"
    # the same store and trace as JAX's
    jclient = _client(jbank.build_bank_app(), JPOSClient)
    _run(jclient, mode=None, populate=jbank.populate_bank_store)
    assert store_dump(store) == store_dump(jclient.store)
    assert store.snapshot_metrics() == jclient.store.snapshot_metrics()


def test_capre_prefetch_covers_accessed_objects():
    client = _client()
    root = populate_bank_store(client.store, n_transactions=60)
    with client.session("bank", mode="capre") as s:
        s.execute(root, "auditAll")
        assert s.drain(10.0)
    accessed = client.store.accessed_oids - {root}
    missing = accessed - client.store.prefetched_oids
    assert not missing, f"CAPre failed to predict {len(missing)} accessed objects"
    assert client.store.prefetch_accuracy()["recall"] >= 0.99


def test_capre_prefetch_on_mutating_traversal_still_high_recall():
    client = _client()
    root = _run(client, mode="capre")
    missing = (client.store.accessed_oids - {root}) - client.store.prefetched_oids
    assert all(client.store.cls_of(o) == "Customer" for o in missing)


def test_rop_never_prefetches_collections():
    client = _client()
    root = _run(client, mode="rop", rop_depth=5)
    tx_oids = set(client.store.peek(root).fields["transactions"])
    assert not (client.store.prefetched_oids & tx_oids)


def test_rop_depth_increases_coverage():
    """ROP at depth 3 covers what it covers at depth 1, and more.  The JAX
    test counts the oids two online sessions land as prefetched; at zero
    latency which of them land before the application reaches them is a
    race between threads, on either package, so the twin holds the claim
    where it is deterministic: replayed offline over the recorded
    traversal (setAllTransCustomers, a miss on each oid's first access),
    what ROP predicts on each miss at depth 3 contains what it predicts at
    depth 1, some miss predicts more, and both depths equal JAX's; and both
    online sessions run to the store of no prefetching."""
    predicted = {}
    for pkg in ("repro_torch", "repro"):
        client, _root, _fp, traces, _metrics = _recorded(pkg, "bank_write")
        for depth in (1, 3):
            rows = replay_offline(pkg, "rop", client, "bank", traces[0], traces[1],
                                  rop_depth=depth)
            predicted[pkg, depth] = [row[1] for row in rows]
    assert predicted["repro_torch", 1] == predicted["repro", 1]
    assert predicted["repro_torch", 3] == predicted["repro", 3]
    pairs = list(zip(predicted["repro_torch", 1], predicted["repro_torch", 3]))
    assert all(set(d1) <= set(d3) for d1, d3 in pairs)
    assert any(set(d1) < set(d3) for d1, d3 in pairs)
    client = _client()
    r1 = _run(client, mode="rop", rop_depth=1)
    client.store.reset_runtime_state()
    with client.session("bank", mode="rop", rop_depth=3) as s:
        s.execute(r1, "setAllTransCustomers")
        assert s.drain(10.0)
    assert client.store.prefetched_oids
    jclient = _client(jbank.build_bank_app(), JPOSClient)
    jroot = _run(jclient, mode=None, populate=jbank.populate_bank_store)
    with jclient.session("bank") as s:
        s.execute(jroot, "setAllTransCustomers")
    assert store_dump(client.store) == store_dump(jclient.store)


def test_metrics_accounting():
    client = _client()
    _run(client, mode=None, n_tx=20)
    m = client.store.snapshot_metrics()
    assert m["app_loads"] > 0
    assert m["app_cache_misses"] > 0
    assert m["prefetch_loads"] == 0
    assert m["batch_dispatches"] == 0
    assert m["writes"] > 0
    jclient = _client(jbank.build_bank_app(), JPOSClient)
    _run(jclient, mode=None, n_tx=20, populate=jbank.populate_bank_store)
    assert m == jclient.store.snapshot_metrics()


# ---------------------------------------------------------------------------
# twins of tests/test_cache_eviction.py
# ---------------------------------------------------------------------------


def test_lru_evicts_least_recently_used():
    store = ObjectStore(n_services=1, latency=ZERO, cache_capacity=3)
    ds = store.services[0]
    oids = [store.put("X", {"i": i}) for i in range(5)]
    for o in oids[:3]:
        ds.load_into_memory(o)
    ds.load_into_memory(oids[0])
    ds.load_into_memory(oids[3])
    assert ds.is_cached(oids[0])
    assert not ds.is_cached(oids[1])
    assert ds.is_cached(oids[2]) and ds.is_cached(oids[3])
    assert ds.evictions == 1


def test_unbounded_cache_never_evicts():
    store = ObjectStore(n_services=1, latency=ZERO, cache_capacity=0)
    ds = store.services[0]
    for i in range(100):
        ds.load_into_memory(store.put("X", {"i": i}))
    assert ds.evictions == 0
    assert len(ds.cache) == 100


def test_bounded_cache_increases_misses_under_rop_but_capre_recall_survives():
    lat = LatencyModel(disk_load=250e-6, remote_hop=0.0, write_back=0.0, think=120e-6)
    results = {}
    for mode in (None, "capre"):
        client = POSClient(n_services=4)
        client.store = ObjectStore(n_services=4, latency=lat, cache_capacity=64)
        client.register(build_wordcount_app())
        root = populate_wordcount(client.store, chunks_per_text=16, words_per_chunk=8)
        with client.session("wordcount", mode=mode, parallel_workers=16) as s:
            s.execute(root, "run")
            s.drain(10.0)
        results[mode] = client.store.metrics.snapshot()
    assert results["capre"]["app_cache_hits"] > results[None]["app_cache_hits"]
    assert results["capre"]["app_cache_misses"] < results[None]["app_cache_misses"]


# ---------------------------------------------------------------------------
# twins of tests/test_benchmark_apps.py
# ---------------------------------------------------------------------------


def test_wordcount_hints():
    report = analyze_application(build_wordcount_app())
    assert report.hints_str("WCJob.run") == {"collections[].texts[].stats",
                                             "collections[].texts[].chunks[]"}


def test_kmeans_hints_and_rop_has_nothing():
    app = build_kmeans_app()
    report = analyze_application(app)
    assert report.hints_str("KMeansJob.run") == {"collections[].vectors[]"}
    for cls in app.classes:
        assert rop_hints(app, cls, 5) == ()


def test_pga_dfs_vs_bellman_ford_hints():
    report = analyze_application(build_pga_app())
    assert report.hints_str("WeightedDirectedGraph.dfs") == {"vertices[].edges[].toVertex"}
    assert report.hints_str("WeightedDirectedGraph.bellmanFord") == set()


def test_oo7_hints_respect_override_exclusion():
    report = analyze_application(build_oo7_app())
    assert report.hints_str("OO7Bench.t1") == {"module.designRoot.subAssemblies[]"}
    base = report.hints_str("BaseAssembly.traverse")
    assert "components[].documentation" in base
    assert "components[].rootPart.to[].toPart" in base


def _words(store, root) -> Counter:
    expect = Counter()
    for tc in store.peek(root).fields["collections"]:
        for t in store.peek(tc).fields["texts"]:
            for ch in store.peek(t).fields["chunks"]:
                expect.update(store.peek(ch).fields["words"])
    return expect


@pytest.mark.parametrize("mode", [None, "capre", ("rop", 2)])
def test_wordcount_result_matches_oracle(mode):
    c = _client(build_wordcount_app())
    root = populate_wordcount(c.store, chunks_per_text=8, words_per_chunk=16)
    kwargs = ({"mode": mode} if not isinstance(mode, tuple)
              else {"mode": mode[0], "rop_depth": mode[1]})
    with c.session("wordcount", **kwargs) as s:
        got = s.execute(root, "run")
        assert s.drain(10.0)
    assert got == _words(c.store, root)
    # JAX's app counts the same words
    jc = _client(jwordcount.build_wordcount_app(), JPOSClient)
    jroot = jwordcount.populate_wordcount(jc.store, chunks_per_text=8, words_per_chunk=16)
    with jc.session("wordcount") as s:
        assert s.execute(jroot, "run") == got


def test_kmeans_result_matches_oracle():
    c = _client(build_kmeans_app())
    root = populate_kmeans(c.store, n_vectors=80, dims=4)
    cents = initial_centroids(k=4, dims=4)
    with c.session("kmeans", mode="capre") as s:
        got = s.execute(root, "run", [list(x) for x in cents])
        assert s.drain(10.0)
    vectors = []
    for vc in c.store.peek(root).fields["collections"]:
        for v in c.store.peek(vc).fields["vectors"]:
            vectors.append(c.store.peek(v).fields["dims"])
    ref = [list(x) for x in cents]
    for _ in range(c.store.peek(root).fields["iters"]):
        sums = [[0.0] * 4 for _ in range(4)]
        counts = [0] * 4
        for dims in vectors:
            cl = _nearest(dims, ref)
            sums[cl] = [a + b for a, b in zip(sums[cl], dims)]
            counts[cl] += 1
        ref = [[s / counts[i] for s in sums[i]] if counts[i] else ref[i] for i in range(4)]
    for a, b in zip(got, ref):
        assert a == pytest.approx(b)


def test_pga_bellman_ford_matches_oracle():
    from repro_torch.pos.interp import ObjRef

    c = _client(build_pga_app())
    g, src = populate_pga(c.store, n_vertices=60, out_degree=3)
    with c.session("pga", mode="capre") as s:
        dist = s.execute(g, "bellmanFord", ObjRef(src))
        assert s.drain(10.0)
    adj: dict[int, list[tuple[int, float]]] = {}
    for v in c.store.peek(g).fields["vertices"]:
        edges = []
        for e in c.store.peek(v).fields["edges"]:
            rec = c.store.peek(e)
            edges.append((rec.fields["toVertex"], rec.fields["weight"]))
        adj[v] = edges
    ref = {src: 0.0}
    pq = [(0.0, src)]
    while pq:
        d, u = heapq.heappop(pq)
        if d > ref.get(u, float("inf")):
            continue
        for v, w in adj[u]:
            nd = d + w
            if nd < ref.get(v, float("inf")):
                ref[v] = nd
                heapq.heappush(pq, (nd, v))
    got = {k.oid: v for k, v in dist.items()}
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == pytest.approx(ref[k])
    # JAX's interpreter gives the same distances, bit for bit
    from repro.pos.interp import ObjRef as JObjRef

    jc = _client(jpga.build_pga_app(), JPOSClient)
    jg, jsrc = jpga.populate_pga(jc.store, n_vertices=60, out_degree=3)
    with jc.session("pga") as s:
        jdist = s.execute(jg, "bellmanFord", JObjRef(jsrc))
    assert {k.oid: v for k, v in jdist.items()} == got


def test_pga_dfs_visits_everything_once():
    c = _client(build_pga_app())
    g, _ = populate_pga(c.store, n_vertices=50, out_degree=3)
    with c.session("pga") as s:
        total = s.execute(g, "dfs")
    verts = set(c.store.peek(g).fields["vertices"])
    assert verts <= c.store.accessed_oids
    assert total > 0
    jc = _client(jpga.build_pga_app(), JPOSClient)
    jg, _ = jpga.populate_pga(jc.store, n_vertices=50, out_degree=3)
    with jc.session("pga") as s:
        assert s.execute(jg, "dfs") == total


def test_oo7_t1_visits_all_atomic_parts():
    c = _client(build_oo7_app())
    root = populate_oo7(c.store, size="small")
    with c.session("oo7", mode="capre") as s:
        s.execute(root, "t1")
        assert s.drain(20.0)
    atomic = {oid for ds in c.store.services for oid, rec in ds.disk.items()
              if rec.cls == "AtomicPart"}
    assert atomic <= c.store.accessed_oids


def test_oo7_t2b_write_counts():
    c = _client(build_oo7_app())
    root = populate_oo7(c.store, size="small")
    with c.session("oo7") as s:
        s.execute(root, "t2b")
    atomic_count = sum(1 for ds in c.store.services for rec in ds.disk.values()
                       if rec.cls == "AtomicPart")
    assert c.store.metrics.writes == 2 * atomic_count
    jc = _client(joo7.build_oo7_app(), JPOSClient)
    jroot = joo7.populate_oo7(jc.store, size="small")
    with jc.session("oo7") as s:
        s.execute(jroot, "t2b")
    assert store_dump(c.store) == store_dump(jc.store)
    assert c.store.snapshot_metrics() == jc.store.snapshot_metrics()


def test_kmeans_capre_recall_perfect():
    c = _client(build_kmeans_app())
    root = populate_kmeans(c.store, n_vectors=100, dims=4)
    with c.session("kmeans", mode="capre") as s:
        s.execute(root, "run", initial_centroids(k=4, dims=4))
        assert s.drain(10.0)
    acc = c.store.prefetch_accuracy()
    assert acc["recall"] >= 0.99
    assert acc["false_positives"] == 0


# ---------------------------------------------------------------------------
# the committed traces and the catalog's recordings
# ---------------------------------------------------------------------------

_RECORDED: dict = {}


def _recorded(pkg: str, key: str):
    if (pkg, key) not in _RECORDED:
        _RECORDED[pkg, key] = record(pkg, key)
    return _RECORDED[pkg, key]


@pytest.mark.parametrize("key", GOLDEN)
def test_committed_trace_reproduced_exactly(key):
    """The port's own ``record_workload`` (trace cache off) gives the
    committed file: fingerprint, both event streams, the store after the
    runs and the put log."""
    client, _root, fp, traces, _metrics = _recorded("repro_torch", key)
    blob = golden(key)
    assert fp == blob["fingerprint"]
    assert [events(t) for t in traces] == blob["traces"]
    assert store_dump(client.store) == blob["store"]
    assert put_log(client.store) == blob["put_log"]


@pytest.mark.parametrize("key", CATALOG)
def test_catalog_recording_equals_jax(key):
    """Every catalog workload (those without a committed file too) records
    on the port exactly as on JAX: each run's events and
    ``snapshot_metrics``, the populated store's fingerprint, the store
    after the runs and the put log; ``record``'s hooks (the fingerprint
    and per-run metrics it takes) change nothing of JAX's plain
    ``record_workload``."""
    client, root, fp, traces, metrics = _recorded("repro_torch", key)
    jclient, jroot, jfp, jtraces, jmetrics = _recorded("repro", key)
    assert root == jroot and fp == jfp
    assert [events(t) for t in traces] == [events(t) for t in jtraces]
    assert metrics == jmetrics
    assert metrics[-1]["prefetch_loads"] == 0 and metrics[-1]["app_loads"] > 0
    assert store_dump(client.store) == store_dump(jclient.store)
    assert put_log(client.store) == put_log(jclient.store)
    rclient, rroot, rtraces = jrecord_workload(jcatalog()[key], runs=2)
    assert rroot == root
    assert [events(t.events) for t in rtraces] == [events(t) for t in traces]
    assert store_dump(rclient.store) == store_dump(client.store)
    assert rclient.store.snapshot_metrics() == metrics[-1]


def test_fingerprint_sees_a_changed_field():
    client, root, fp, _traces, _metrics = _recorded("repro_torch", "wordcount")
    reg = client.logic_module.registered["wordcount"]
    rec = client.store.peek(root)
    saved = dict(rec.fields)
    rec.fields["marker"] = 1
    try:
        assert fingerprint(client.store, root, reg)["content_sha1"] != fp["content_sha1"]
    finally:
        rec.fields.clear()
        rec.fields.update(saved)


# ---------------------------------------------------------------------------
# a Session in every registered mode
# ---------------------------------------------------------------------------


def test_pos_registry_equals_jax():
    assert predict.available("pos") == javailable("pos")
    assert predict.available("stream") == javailable("stream")
    for mode in predict.available("pos"):
        assert predict.make_pos_predictor(mode).name == mode
    with pytest.raises(KeyError):
        predict.make_pos_predictor("nope")


@pytest.mark.parametrize("traversal", ("auditAll", "setAllTransCustomers"))
@pytest.mark.parametrize("mode", [None, *predict.available("pos"), "capre", "markov"])
def test_session_in_every_mode_leaves_the_store_of_no_prefetch(mode, traversal):
    """Each mode runs the traversal to the same result and the same final
    store as prefetch off (JAX's, on JAX's own objects); a prefetching mode
    loads ahead, mode None never does, CAPre's recall on the read-only
    traversal is at least 0.99, and closing the session removes its
    hooks."""
    warm = None
    if mode in ("markov-miner", "markov", "hybrid"):
        warm = trace_oids(_recorded("repro_torch", "bank" if traversal == "auditAll"
                                    else "bank_write")[3][0])
    c = _client()
    root = populate_bank_store(c.store, n_transactions=60)
    overrides = {"warm_trace": warm} if warm is not None else {}
    with c.session("bank", mode=mode, **overrides) as s:
        got = s.execute(root, traversal)
        assert s.drain(10.0)
    assert c.store.miss_listener is None and c.store.access_listener is None
    jc = _client(jbank.build_bank_app(), JPOSClient)
    jroot = jbank.populate_bank_store(jc.store, n_transactions=60)
    with jc.session("bank") as s:
        jgot = s.execute(jroot, traversal)
    assert got == jgot
    assert store_dump(c.store) == store_dump(jc.store)
    m = c.store.snapshot_metrics()
    assert m["app_loads"] == jc.store.snapshot_metrics()["app_loads"]
    if mode is None:
        assert m["prefetch_loads"] == 0 and not c.store.prefetched_oids
    else:
        assert m["prefetch_requests"] > 0
    if mode in ("static-capre", "capre") and traversal == "auditAll":
        assert c.store.prefetch_accuracy()["recall"] >= 0.99
