"""Offline trace-replay evaluation harness (DESIGN.md section 3.3).

Turns ``ObjectStore.trace`` from a debugging aid into the substrate for a
head-to-head comparison of every registered predictor:

  1. **record** — run a benchmark workload with prefetching off, capturing
     the interleaved schema-v2 event stream (``pos.trace``): method entries
     (the injected scheduling points), application-path reads *and* writes;
     two cold-cache runs are recorded so trace miners can train on the
     first and be scored on the second (the warm-up run a monitoring
     approach needs anyway).  The apps record concurrently on a thread
     pool — each gets its own store.
  2. **replay** — feed the eval run's events to a fresh instance of each
     predictor under a **virtual clock** driven by the pure-arithmetic side
     of ``pos.latency``: every predicted oid is scheduled on its Data
     Service's ``VirtualDisk`` (``parallel_per_ds`` slots) and gets a
     deterministic *ready-at* time; every access gets a *needed-at* time
     (remote hops + think time advance the application clock).  A bounded
     per-service LRU cache (``cache_capacity``) charges eager predictors
     for thrash evictions.
  3. **score** — precision/recall via the same ``prefetch_accuracy``
     definition the live store uses, **coverage** (order-aware: the oid was
     predicted before the access, latency ignored), and the timeliness
     metrics the paper's argument actually rests on:

     * ``timely_coverage`` — fraction of demand events (reads and writes)
       whose oid was predicted AND resident (ready-at <= needed-at);
     * ``partial_hide``    — fraction whose predicted load was still in
       flight at need (the app stalls for the remainder only);
     * ``stall_seconds``   — simulated disk wait on the app critical path,
       alongside the no-prefetch baseline and the percentage saved.

     Writes are charged end-to-end: an uncached write is write-allocated
     (a demand load on the virtual clock), a resident write dirties its
     cache line, and evicting a dirty line schedules ``write_back``
     occupancy on the same ``VirtualDisk`` slots loads use — so mutating
     workloads (``bank_write`` = the paper's ``setAllTransCustomers``)
     are scored for timeliness too.

Replay is fully deterministic (no real sleeping, no real threads in the
scoring loop), so the CSV artifacts written under ``artifacts/predict/``
are regression-checkable across PRs (``benchmarks/compare_predict.py``).
``benchmarks/bench_predictors.py`` is the wall-clock companion.

Run: ``PYTHONPATH=src python -m repro_torch.predict.evaluate
[--fast] [--apps a,b] [--cache-capacity 0,64,256]
[--cache-policy lru,prefetch-aware] [--shared-budget] [--out artifacts/predict]``
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from repro_torch.pos.client import POSClient, Session, SessionConfig
from repro_torch.pos.eviction import DEFAULT_POLICY, SharedBudget, make_policy
from repro_torch.pos.latency import REPLAY, LatencyModel, VirtualDisk
from repro_torch.pos.store import prefetch_accuracy
from repro_torch.pos.trace import (
    ACCESS,
    METHOD_ENTRY,
    TRACE_SCHEMA_VERSION,
    WRITE,
    TraceEvent,
    as_events,
    trace_oids,
)

from . import available, make_pos_predictor
from .base import Predictor


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------


@dataclass
class RecordedTrace:
    """One cold-cache run of a workload: the interleaved schema-v2 event
    stream (``pos.trace.TraceEvent``: access / write / method_entry) plus
    the plain demand-oid sequence for bare-oid consumers (miners' ``warm``,
    accuracy sets)."""

    app_name: str
    workload: str
    events: list[TraceEvent]
    accesses: list[int]  # demand-path oids (reads + writes), in order
    schema_version: int = TRACE_SCHEMA_VERSION

    def __len__(self) -> int:
        return len(self.events)


@dataclass
class Workload:
    """A benchmark app + a traversal to trace, in the same shape the
    benchmark driver uses (``run_once(session, root)``).  ``key`` names the
    catalog entry (distinct traversals of one app — e.g. ``bank`` vs
    ``bank_write`` — share ``name``, the registered application)."""

    name: str
    build_app: Callable
    populate: Callable[[object], int]
    run_once: Callable[[Session, int], None]
    workload: str = "run"
    key: str = ""

    def __post_init__(self) -> None:
        if not self.key:
            self.key = self.name


def _catalog() -> dict[str, Workload]:
    """The five paper benchmark apps with trace-friendly (small) sizes."""
    from repro_torch.apps.bank import build_bank_app, populate_bank_store
    from repro_torch.apps.kmeans import build_kmeans_app, initial_centroids, populate_kmeans
    from repro_torch.apps.oo7 import build_oo7_app, populate_oo7
    from repro_torch.apps.pga import build_pga_app, populate_pga
    from repro_torch.apps.wordcount import build_wordcount_app, populate_wordcount

    cents = [list(c) for c in initial_centroids(k=3, dims=6)]
    return {
        "bank": Workload(
            "bank",
            build_bank_app,
            lambda store: populate_bank_store(store, n_transactions=60),
            lambda s, root: s.execute(root, "auditAll"),
            workload="auditAll",
        ),
        # the mutating traversal (paper Listing 1): getAccount navigation +
        # conditional account.cust updates — the write path under test
        "bank_write": Workload(
            "bank",
            build_bank_app,
            lambda store: populate_bank_store(store, n_transactions=60),
            lambda s, root: s.execute(root, "setAllTransCustomers"),
            workload="setAllTransCustomers",
            key="bank_write",
        ),
        "wordcount": Workload(
            "wordcount",
            build_wordcount_app,
            lambda store: populate_wordcount(store, chunks_per_text=8, words_per_chunk=6),
            lambda s, root: s.execute(root, "run"),
        ),
        "kmeans": Workload(
            "kmeans",
            build_kmeans_app,
            lambda store: populate_kmeans(store, n_vectors=240, n_collections=3, dims=6),
            lambda s, root: s.execute(root, "run", cents),
        ),
        "oo7": Workload(
            "oo7",
            build_oo7_app,
            lambda store: populate_oo7(store, size="small"),
            lambda s, root: s.execute(root, "t1"),
            workload="t1",
        ),
        "pga": Workload(
            "pga",
            build_pga_app,
            lambda store: _pga_populate(store, populate_pga),
            lambda s, root: s.execute(root, "dfs"),
            workload="dfs",
        ),
    }


def _pga_populate(store, populate_pga) -> int:
    g, _src = populate_pga(store, n_vertices=120, out_degree=3)
    return g


# -- trace memoization -------------------------------------------------------
#
# Recording a workload means interpreting its full traversal — by far the
# slowest part of an evaluate run, and it was re-executed on every
# invocation (and every test session) even though recording is fully
# deterministic.  Traces are now memoized to disk: the cache entry stores
# the recorded event streams AND the post-recording store contents (field
# values matter — mutating workloads leave the store in the warm state the
# replay's hint expansion reads), guarded by a fingerprint of the freshly
# populated store so any change to an app or its populate sizes invalidates
# the entry.  ``--no-trace-cache`` (or CAPRE_TRACE_CACHE=0) bypasses it.

TRACE_CACHE_VERSION = 2  # v2: blob carries the put log (placement rebuilds)
DEFAULT_TRACE_CACHE_DIR = os.path.join("artifacts", "predict", "traces")


def _resolve_trace_cache(trace_cache: Optional[str]) -> Optional[str]:
    """``None``/empty disables caching; the sentinel ``"default"`` resolves
    the ``CAPRE_TRACE_CACHE`` env override (``0``/empty disables, any other
    value is the cache directory) and falls back to the artifacts dir."""
    if trace_cache != "default":
        return trace_cache or None
    env = os.environ.get("CAPRE_TRACE_CACHE")
    if env is not None:
        return None if env in ("", "0") else env
    return DEFAULT_TRACE_CACHE_DIR


def _trace_cache_path(cache_dir: str, wl: Workload, runs: int, n_services: int) -> str:
    name = (f"{wl.key}_r{runs}_ds{n_services}"
            f"_v{TRACE_SCHEMA_VERSION}.{TRACE_CACHE_VERSION}.json")
    return os.path.join(cache_dir, name)


def _store_fingerprint(store, root: int, reg=None) -> dict:
    """Identity of the freshly populated store — shape counts plus a
    content hash of every object's class and field values, and (when the
    registration is available) of the analysis hints, whose per-method
    navigation structure changes whenever a traversal method's shape
    does.  Any mismatch invalidates the cache entry and re-records.
    Residual blind spot: an edit confined to ``Compute`` bodies that
    flips control flow without touching schema, hints, or populate
    output — use ``--no-trace-cache`` when iterating on those."""
    import hashlib

    h = hashlib.sha1()
    n_objects = 0
    for ds in store.services:
        for oid in sorted(ds.disk):
            rec = ds.disk[oid]
            n_objects += 1
            h.update(repr((ds.ds_id, oid, rec.cls, sorted(rec.fields.items()))).encode())
    if reg is not None:
        h.update(repr(sorted(
            (key, tuple(hint.steps for hint in hints))
            for key, hints in reg.report.hints.items()
        )).encode())
    return {
        "root": root,
        "n_objects": n_objects,
        "n_services": len(store.services),
        "content_sha1": h.hexdigest(),
    }


def _snapshot_store(store) -> list:
    """JSON-serializable dump of every Data Service's disk (oid, class,
    fields) — field values included, so the warm post-recording state of a
    mutating workload round-trips."""
    return [
        [[rec.oid, rec.cls, rec.fields] for _oid, rec in sorted(ds.disk.items())]
        for ds in store.services
    ]


def _apply_store_snapshot(store, snapshot: list, put_log: list) -> None:
    import itertools

    from repro_torch.pos.store import PersistentObject

    store._placement.clear()
    max_oid = 0
    for ds, objs in zip(store.services, snapshot):
        ds.disk.clear()
        for oid, cls, fields in objs:
            ds.disk[oid] = PersistentObject(oid=oid, cls=cls, fields=fields)
            store._placement[oid] = (ds.ds_id,)
            max_oid = max(max_oid, oid)
    # the creation log (oid, cls, group, pin) rides along so a cached store
    # can still rebuild_placement() under another policy/replication
    store._put_log = [
        (oid, cls, group, pin) for oid, cls, group, pin in put_log
    ]
    store._oid_counter = itertools.count(max_oid + 1)


def _load_cached_traces(path: str, wl: Workload, fingerprint: dict) -> Optional[tuple]:
    import json

    try:
        with open(path) as f:
            blob = json.load(f)
    except (OSError, ValueError):
        return None
    if blob.get("fingerprint") != fingerprint:
        return None  # app/populate changed since this entry was written
    traces = [
        RecordedTrace(
            app_name=wl.name,
            workload=wl.workload,
            events=as_events([tuple(ev) for ev in run]),
            accesses=trace_oids([tuple(ev) for ev in run]),
        )
        for run in blob["traces"]
    ]
    return blob["store"], blob.get("put_log", []), traces


def _save_cached_traces(path: str, fingerprint: dict, store,
                        traces: list[RecordedTrace]) -> None:
    import json

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = {
        "fingerprint": fingerprint,
        "store": _snapshot_store(store),
        "put_log": [list(entry) for entry in store._put_log],
        "traces": [[ev.to_tuple() for ev in t.events] for t in traces],
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(blob, f)
    os.replace(tmp, path)  # atomic: concurrent recorders cannot torn-write


def record_workload(
    wl: Workload, runs: int = 2, n_services: int = 4, cache_dir: Optional[str] = None
) -> tuple[POSClient, int, list[RecordedTrace]]:
    """Populate a zero-latency store and record ``runs`` cold-cache traces
    of the workload with prefetching off.  ``ObjectStore.trace`` captures
    the full schema-v2 event stream (method entries via the Session hook,
    reads via ``app_access``, writes via ``app_write``).  Returns the live
    client (replay needs the object graph and the registration analysis)
    plus the traces.  For mutating workloads the train run's updates are
    visible to the eval run — exactly the warm-store regime a monitoring
    predictor trains in.  With ``cache_dir`` the recorded traces (and the
    post-recording store state) are memoized to disk, keyed by workload,
    run count, service count and trace schema version; on a hit the
    traversals are not re-executed."""
    client = POSClient(n_services=n_services)
    reg = client.register(wl.build_app())
    root = wl.populate(client.store)
    path = fingerprint = None
    if cache_dir:
        path = _trace_cache_path(cache_dir, wl, runs, n_services)
        fingerprint = _store_fingerprint(client.store, root, reg)
        if os.path.exists(path):
            cached = _load_cached_traces(path, wl, fingerprint)
            if cached is not None:
                snapshot, put_log, traces = cached
                _apply_store_snapshot(client.store, snapshot, put_log)
                return client, root, traces
    traces = []
    for _ in range(runs):
        client.store.reset_runtime_state()
        client.store.trace = []
        session = Session(client.store, client.logic_module.registered[wl.name])
        try:
            wl.run_once(session, root)
        finally:
            session.close()
        events = list(client.store.trace)
        traces.append(
            RecordedTrace(
                app_name=wl.name,
                workload=wl.workload,
                events=events,
                accesses=trace_oids(events),
            )
        )
        client.store.trace = None
    if path is not None:
        _save_cached_traces(path, fingerprint, client.store, traces)
    return client, root, traces


def record_catalog(
    workloads: Sequence[Workload], runs: int = 2, max_workers: Optional[int] = None,
    cache_dir: Optional[str] = None,
) -> dict[str, tuple[POSClient, int, list[RecordedTrace]]]:
    """Record every workload concurrently, each on its own store, so the
    traces stay byte-identical to serial recording.  On the default
    zero-latency store the interpreter is CPU-bound and the GIL caps the
    overlap; the pool pays off when recording is given a sleeping latency
    model (and costs nothing but threads otherwise).  ``cache_dir`` is
    passed through to ``record_workload`` (disk-memoized traces).  Returns
    ``{workload_key: (client, root, traces)}`` in the order requested."""
    if max_workers is None:
        max_workers = max(1, len(workloads))
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        futures = {
            wl.key: pool.submit(record_workload, wl, runs, 4, cache_dir)
            for wl in workloads
        }
        return {key: fut.result() for key, fut in futures.items()}


# ---------------------------------------------------------------------------
# virtual-clock replay
# ---------------------------------------------------------------------------


@dataclass
class _CacheEntry:
    source: str  # "pf" | "demand"
    used: bool = False
    dirty: bool = False


class VirtualReplay:
    """The timeliness engine: one ``VirtualDisk`` + bounded LRU per Data
    Service, an application clock advanced by remote hops / stalls / think
    time, and prefetch loads that become resident at their *done* time.

    Semantics mirror the live store: a prefetch loads the object where it
    is stored (no redirection charged); a demand miss queues on the same
    disk slots the prefetches occupy, so over-eager predictors congest the
    application's own loads; concurrent interest in one oid coalesces onto
    the in-flight load.  Writes write-allocate (an uncached write is a
    demand load), dirty their cache line, and evicting a dirty line
    schedules ``write_back`` occupancy on the same disk slots — off the
    app's critical path, but delaying loads queued behind it.

    Eviction order is delegated to the same ``pos.eviction`` policies the
    live ``DataService`` runs, so simulated and measured thrash come from
    one code path.  ``shared_budget=True`` makes ``cache_capacity`` one
    global line budget drawn on by every service (one policy instance spans
    them all and victims are stolen wherever they live), mirroring the
    store's ``SharedBudget`` mode."""

    def __init__(self, store, latency: LatencyModel = REPLAY, cache_capacity: int = 0,
                 policy: str = DEFAULT_POLICY, shared_budget: bool = False,
                 dispatch: str = "per-oid", tracer=None, scenario=None,
                 rfo_enabled: bool = True, executor_workers: int = 8,
                 write_quorum: int = 1):
        from repro_torch.obs import Histogram, Meter

        n = len(store.services)
        self.store = store
        self.latency = latency
        self.cache_capacity = cache_capacity
        self.policy_name = policy
        self.shared_budget = shared_budget and bool(cache_capacity)
        # dispatch granularity mirrored from the live runtime: "per-oid"
        # issues one executor submission per predicted oid (the i-th load
        # starts ~i*dispatch_overhead late — submissions serialize on the
        # dispatching thread); "batch" groups a prediction by Data Service,
        # dedupes against cache + in-flight before submission, and pays one
        # dispatch_overhead per service batch
        self.dispatch = dispatch
        if self.shared_budget:
            # the store's own SharedBudget (owners are Data-Service indices
            # here; its lock is unused — replay is single-threaded)
            self.budget: Optional[SharedBudget] = SharedBudget(cache_capacity, policy=policy)
            self.policies = [self.budget.policy] * n
        else:
            self.budget = None
            self.policies = [make_policy(policy, capacity=cache_capacity) for _ in range(n)]
        # failure regime (pos.latency.FailureScenario): per-service disk
        # scales model stragglers directly on each VirtualDisk; a crash is
        # applied lazily once the virtual clock passes crash_at (so the
        # in-flight prefetch state at that instant is what gets lost) —
        # the virtual-clock mirror of crash_service + failover routing
        self.scenario = scenario
        scales = scenario.straggler_scales() if scenario is not None else {}
        self.dead: set[int] = set()
        # services across the network cut (partitioned regimes): routed
        # around like the dead, but their state survives — at heal they
        # readmit warm and resync the writes they missed
        self.cut: set[int] = set()
        self.failovers = 0  # in-flight prefetch loads re-dispatched off the corpse
        self.crash_lost = 0  # resident lines lost with the crashed cache
        # recovery counters (mirror StoreMetrics)
        self.readmissions = 0
        self.resync_lines = 0
        self.hedged_reads = 0
        self.hedge_wins = 0
        self.quorum_writes = 0
        self.quorum_acks = 0
        self.quorum_retries = 0
        self.quorum_failures = 0
        # replicated writes wait for W-of-R acks (1 = async/sloppy legacy)
        self.write_quorum = max(1, write_quorum)
        # anti-entropy write log: replica -> oids missed while dead/cut
        self._missed_writes: dict[int, set[int]] = {}
        # per-tenant failover attribution for the loadsim driver
        self.failovers_by_tenant: dict[str, int] = {}
        # fault timeline: the scenario's one-shot events, applied lazily in
        # time order the moment the virtual clock passes each (so in-flight
        # state at that instant is what each event catches)
        self._fault_events: list[tuple[float, str]] = []
        if scenario is not None:
            inf = float("inf")
            if scenario.crash_service is not None and scenario.crash_at < inf:
                self._fault_events.append((scenario.crash_at, "crash"))
                if scenario.revive_at < inf:
                    self._fault_events.append((scenario.revive_at, "revive"))
            if scenario.partition and scenario.partition_at < inf:
                self._fault_events.append((scenario.partition_at, "partition"))
                if scenario.heal_at < inf:
                    self._fault_events.append((scenario.heal_at, "heal"))
            self._fault_events.sort()
        self.disks = [VirtualDisk(latency, scale=scales.get(i, 1.0))
                      for i in range(n)]
        self.caches: list[dict[int, _CacheEntry]] = [{} for _ in range(n)]
        self.inflight: list[dict[int, tuple[float, float]]] = [{} for _ in range(n)]
        self.t = 0.0
        self.cur_ds: Optional[int] = None
        # counters (n_access counts every demand event, reads and writes)
        self.n_access = 0
        self.timely = 0
        self.partial = 0
        self.remote_hops = 0
        self.stall_seconds = 0.0
        self.hidden_seconds = 0.0
        self.demand_loads = 0
        self.prefetch_loads = 0
        self.prefetch_requests = 0
        self.evictions = 0
        self.evicted_before_use = 0
        self.thrash_misses = 0
        self.writes = 0
        self.write_hits = 0  # writes that found the line resident
        self.dirty_evictions = 0
        self.flushed_writes = 0
        self.batch_dispatches = 0  # executor submissions the predictions cost
        self.dedup_suppressed = 0  # oids suppressed before submission (batch mode)
        # -- static-optimizer signals (core.opt) ----------------------------
        # rfo_enabled=False ignores read-for-ownership marks (the A/B
        # control): predictions then never dirty-allocate, and every write
        # to a resident-but-clean line pays the ownership upgrade below
        self.rfo_enabled = rfo_enabled
        self.rfo_prefetches = 0  # prefetch loads landed dirty (RFO)
        self.ownership_upgrades = 0  # writes to resident-but-clean lines
        self._rfo_pending: list[set[int]] = [set() for _ in range(n)]
        # priority stream accounting (mean static priority of the emitted
        # predictions — the bench/compare artifact column)
        self._prio_sum = 0.0
        self._prio_n = 0
        # bounded prefetch-executor pool mirroring the live PrefetchRuntime
        # (parallel_workers=8): a dispatch task occupies a worker slot from
        # its issue until its loads are ready — when predictions outpace the
        # pool, later dispatches queue behind busy workers instead of
        # issuing instantly (the saturation the wall-clock benches hit)
        self._exec_slots = [0.0] * max(1, executor_workers)
        self.exec_delayed = 0  # dispatches that waited for a free worker
        self._evicted_ever: set[int] = set()
        # observability (repro_torch.obs): the virtual clock affords an *exact*
        # per-demand-event stall distribution (every event records 0.0 on a
        # residency hit, the remainder on a partial, the full queue+service
        # wait on a miss) and, optionally, the same lifecycle spans the live
        # store traces — virtual timestamps land in the same span fields, so
        # wall and virtual timelines export through one code path.  The
        # instrumentation's own wall cost accrues on ``obs_meter``.
        self.obs_meter = Meter()
        self.stall_hist = Histogram("stall_s", exact=True, meter=self.obs_meter)
        self.tracer = tracer
        if tracer is not None and tracer.meter is None:
            tracer.meter = self.obs_meter
        # -- multi-tenant attribution (predict.loadsim) ----------------------
        # the loadsim driver time-multiplexes several tenants over one
        # engine (shared disks/caches/executor = the interference model) by
        # setting ``active_tenant`` around each event; prefetched lines
        # remember which tenant scheduled them so an eviction-before-use
        # can be charged to the tenant whose working set was destroyed
        self.active_tenant = ""
        self._pf_owner: dict[int, str] = {}
        self.evicted_by_tenant: dict[str, int] = {}

    # -- cache mechanics ----------------------------------------------------

    def _materialize(self, ds_i: int, t: float) -> None:
        """Promote in-flight loads that completed by ``t`` to resident, in
        completion order (so LRU age matches the virtual timeline).  An
        RFO-marked load lands dirty: the line is owned for writing the
        moment it becomes resident."""
        landed = sorted(
            (done, oid) for oid, (_start, done) in self.inflight[ds_i].items() if done <= t
        )
        for _done, oid in landed:
            del self.inflight[ds_i][oid]
            self._insert(ds_i, oid, "pf")
            self._land_rfo(ds_i, oid)

    def _land_rfo(self, ds_i: int, oid: int) -> None:
        """Dirty-allocate a just-landed prefetch if it was issued RFO."""
        if oid not in self._rfo_pending[ds_i]:
            return
        self._rfo_pending[ds_i].discard(oid)
        entry = self.caches[ds_i].get(oid)
        if entry is not None:
            entry.dirty = True
        self.rfo_prefetches += 1

    def _exec_issue(self, req_t: float) -> tuple[int, float]:
        """Claim the earliest-free prefetch-executor worker for a dispatch
        requested at ``req_t``: returns ``(slot, issue_t)`` where the issue
        waits out the pool when every worker is busy."""
        i = min(range(len(self._exec_slots)), key=self._exec_slots.__getitem__)
        issue = max(req_t, self._exec_slots[i])
        if issue > req_t:
            self.exec_delayed += 1
        return i, issue

    @property
    def protected_evictions(self) -> int:
        policies = {id(p): p for p in self.policies}
        return sum(p.protected_evictions for p in policies.values())

    def _insert(self, ds_i: int, oid: int, source: str, used: bool = False) -> None:
        cache = self.caches[ds_i]
        if oid in cache:
            self.policies[ds_i].note_access(oid, prefetch=(source == "pf"))
        elif self.budget is not None:
            cache[oid] = _CacheEntry(source, used)
            self.budget.note_insert(oid, ds_i, prefetch=(source == "pf"), used=used)
        else:
            cache[oid] = _CacheEntry(source, used)
            self.policies[ds_i].note_insert(oid, prefetch=(source == "pf"), used=used)
        self._evict_overflow(ds_i)

    def _evict_overflow(self, ds_i: int) -> None:
        if not self.cache_capacity:
            return
        if self.budget is not None:
            while self.budget.overflowed():
                holders, victim_oid = self.budget.pick_victim()
                for vds_i in sorted(holders):  # deterministic copy order
                    self._evict(vds_i, victim_oid)
        else:
            while len(self.caches[ds_i]) > self.cache_capacity:
                self._evict(ds_i, self.policies[ds_i].pick_victim())

    def _evict(self, ds_i: int, victim_oid: int) -> None:
        victim = self.caches[ds_i].pop(victim_oid)
        self.evictions += 1
        if self.tracer is not None:
            self.tracer.evicted(victim_oid, t=self.t)
        self._evicted_ever.add(victim_oid)
        if victim.source == "pf" and not victim.used:
            self.evicted_before_use += 1
            owner = self._pf_owner.pop(victim_oid, "")
            if owner:
                # interference: the tenant who prefetched this line lost it
                # before ever using it (evicted by whoever overflowed the
                # shared budget)
                self.evicted_by_tenant[owner] = \
                    self.evicted_by_tenant.get(owner, 0) + 1
        if victim.dirty:
            # the deferred cost of the write path: the flush occupies a
            # disk slot now, delaying whatever loads queue behind it
            self.dirty_evictions += 1
            self.flushed_writes += 1
            self.disks[ds_i].schedule_write_back(self.t)

    # -- replica routing & failure injection ---------------------------------

    def _route(self, oid: int) -> int:
        """Virtual mirror of ``ObjectStore._route_demand``: primary when
        replication is 1 (byte-identical legacy behavior), else the alive
        replica that already holds / is loading the line, falling back to
        the least-queued disk (earliest-free slot; ties in replica order).
        Stragglers deprioritize themselves here — their slots free later."""
        from repro_torch.pos.store import NoReplicaAvailable

        reps = self.store.replicas_of(oid)
        if len(reps) == 1:
            if reps[0] in self.dead or reps[0] in self.cut:
                raise NoReplicaAvailable(oid, reps)
            return reps[0]
        alive = [i for i in reps if i not in self.dead and i not in self.cut]
        if not alive:
            raise NoReplicaAvailable(oid, reps)
        for i in alive:
            if oid in self.caches[i] or oid in self.inflight[i]:
                return i
        return min(alive, key=lambda i: (min(self.disks[i]._slots),
                                         reps.index(i)))

    def _route_prefetch(self, oid: int) -> Optional[int]:
        """Prefetch routing: like ``_route`` but an unreachable object is
        skipped (None) instead of raising — demand surfaces real losses."""
        reps = self.store.replicas_of(oid)
        alive = [i for i in reps if i not in self.dead and i not in self.cut]
        if not alive:
            return None
        if len(alive) == 1:
            return alive[0]
        for i in alive:
            if oid in self.caches[i] or oid in self.inflight[i]:
                return i
        return min(alive, key=lambda i: (min(self.disks[i]._slots),
                                         reps.index(i)))

    def _advance_faults(self) -> None:
        """Apply the scenario's one-shot fault events (crash, partition,
        heal, revive) that the virtual clock has reached, in time order.
        Each event may advance the clock (detection delays), so the loop
        re-checks until no pending event is due."""
        while self._fault_events and self.t >= self._fault_events[0][0]:
            at, kind = self._fault_events.pop(0)
            if kind == "crash":
                self._apply_crash(at)
            elif kind == "partition":
                self._apply_partition(at)
            elif kind == "heal":
                self._apply_heal(at)
            elif kind == "revive":
                self._apply_revive(at)

    def _apply_crash(self, at: float) -> None:
        """The scenario's crash: the service's resident cache dies, its
        in-flight prefetch loads are re-dispatched onto a surviving replica
        ``failover_delay`` after the crash (mirroring
        ``_failover_redispatch`` on the live store), and the application
        clock eats the detection delay once."""
        sc = self.scenario
        i = sc.crash_service
        self.dead.add(i)
        tr = self.tracer
        if tr is not None:
            tr.instant("service-crash", service=i, t=at)
        cache = self.caches[i]
        for oid in list(cache):
            entry = cache.pop(oid)
            if self.budget is not None:
                self.budget.note_remove(oid, i)
            else:
                self.policies[i].note_remove(oid)
            self.crash_lost += 1
            self._evicted_ever.add(oid)
            if entry.source == "pf" and not entry.used:
                self.evicted_before_use += 1
                owner = self._pf_owner.pop(oid, "")
                if owner:
                    self.evicted_by_tenant[owner] = \
                        self.evicted_by_tenant.get(owner, 0) + 1
            if tr is not None:
                tr.evicted(oid, t=at)
        pend, self.inflight[i] = dict(self.inflight[i]), {}
        if tr is not None and pend:
            tr.dropped(list(pend), "service-crash", t=at)
        re_t = at + sc.failover_delay
        self._redispatch(pend, re_t)
        if tr is not None:
            tr.instant("prefetch-failover", service=i, t=re_t,
                       oids=len(pend))
        self.t += sc.failover_delay  # the app notices the failover once

    def _redispatch(self, pend, re_t: float) -> None:
        """Re-dispatch in-flight prefetch loads lost to a crash/partition
        onto reachable replicas at ``re_t`` (one failover per load, charged
        to the tenant whose prefetch it was)."""
        tr = self.tracer
        for oid in pend:
            alt = self._route_prefetch(oid)
            if alt is None:
                continue  # replication 1: the load is simply lost
            start, done = self.disks[alt].schedule(re_t)
            self.inflight[alt][oid] = (start, done)
            self.failovers += 1
            owner = self._pf_owner.get(oid, "")
            if owner:
                self.failovers_by_tenant[owner] = \
                    self.failovers_by_tenant.get(owner, 0) + 1
            self.prefetch_loads += 1
            if tr is not None:
                tr.predicted([oid], "failover", t=re_t)
                tr.dispatched([oid], alt, tr.new_batch(), t=re_t)
                tr.claimed([oid], alt, t=re_t)
                tr.loaded([oid], alt, self.disks[alt].last_slot,
                          re_t, start, done)

    def _apply_partition(self, at: float) -> None:
        """The scenario's network cut: services outside group 0 become
        unreachable.  Their caches and disks survive (unlike a crash); the
        client-side runtime re-dispatches the loads it was waiting on to
        reachable replicas, and the app notices the cut once (one
        detection failover, mirroring the first tripped demand access)."""
        sc = self.scenario
        cut = sc.cut_services()
        self.cut |= cut
        tr = self.tracer
        if tr is not None:
            tr.instant("partition", t=at, cut=sorted(cut))
        re_t = at + sc.failover_delay
        for i in sorted(cut):
            # leave the cut-side in-flight loads in place: they complete
            # server-side and are warm when the partition heals — but the
            # client cannot see them, so they also re-dispatch client-side
            self._redispatch(dict(self.inflight[i]), re_t)
        # detection: the first access that trips over the cut
        self.failovers += 1
        if self.active_tenant:
            self.failovers_by_tenant[self.active_tenant] = \
                self.failovers_by_tenant.get(self.active_tenant, 0) + 1
        self.t += sc.failover_delay

    def _apply_heal(self, at: float) -> None:
        """Heal the cut: every cut service readmits WARM (its cache and the
        loads that completed server-side survive) and anti-entropy resyncs
        the dirty lines whose writes it missed (write-backs on its own disk
        slots, off the app's critical path)."""
        healed, self.cut = set(self.cut), set()
        for i in sorted(healed):
            self._materialize(i, at)
            self.readmissions += 1
            self._resync(i, at)
        tr = self.tracer
        if tr is not None:
            tr.instant("partition-heal", t=at, healed=sorted(healed))

    def _apply_revive(self, at: float) -> None:
        """The crashed service returns: COLD cache (the crash destroyed
        it), rejoins routing, resyncs missed writes."""
        i = self.scenario.crash_service
        self.dead.discard(i)
        self.readmissions += 1
        self._resync(i, at)
        tr = self.tracer
        if tr is not None:
            tr.instant("service-readmit", service=i, t=at)

    def _resync(self, ds_i: int, at: float) -> None:
        """Anti-entropy replay of the write log a returning replica missed:
        one write-back per missed line on the replica's own disk."""
        missed = self._missed_writes.pop(ds_i, set())
        for _oid in sorted(missed):
            self.disks[ds_i].schedule_write_back(at)
            self.resync_lines += 1
            self.flushed_writes += 1

    def _maybe_hedge(self, oid: int, ds_i: int,
                     needed_at: float) -> tuple[int, float, float]:
        """Demand-load dispatch with the hedge race applied on top."""
        start, done = self.disks[ds_i].schedule(needed_at)
        win, w_done = self._hedge_race(oid, ds_i, needed_at, done)
        return win, start, w_done

    def _hedge_race(self, oid: int, ds_i: int, needed_at: float,
                    done: float) -> tuple[int, float]:
        """Read hedging: if hedging is armed and the primary copy (a
        demand load just scheduled, or a prefetch already in flight,
        completing at ``done``) would not land within the hedge delay,
        race a fresh demand read on a second replica issued ``delay``
        after the need and take the first response.  Both disks stay
        charged (the loser's work is real); the losing replica's line is
        *not* retained (a shared budget keys lines by oid — one oid under
        two owners would collide).  Returns the winning ``(service,
        done)`` pair."""
        sc = self.scenario
        if sc is None or not sc.hedge:
            return ds_i, done
        delay = sc.hedge_delay or 3.0 * self.latency.disk_load
        if done - needed_at <= delay:
            return ds_i, done
        reps = self.store.replicas_of(oid)
        alts = [i for i in reps
                if i != ds_i and i not in self.dead and i not in self.cut]
        if not alts:
            return ds_i, done
        alt = min(alts, key=lambda i: (min(self.disks[i]._slots),
                                       reps.index(i)))
        _start, a_done = self.disks[alt].schedule(needed_at + delay)
        self.hedged_reads += 1
        won = a_done < done
        if won:
            self.hedge_wins += 1
        if self.tracer is not None:
            self.tracer.instant("hedged-read", service=alt,
                                t=needed_at + delay, oid=oid, win=won)
        if won:
            return alt, a_done
        return ds_i, done

    def _note_missed_replicas(self, oid: int, ds_i: int) -> None:
        """A dirty write whose replica set includes an unreachable service
        goes into that service's missed-write log; readmission (heal or
        revive) replays it via anti-entropy resync."""
        if not self.dead and not self.cut:
            return
        for r in self.store.replicas_of(oid):
            if r != ds_i and (r in self.dead or r in self.cut):
                self._missed_writes.setdefault(r, set()).add(oid)

    MAX_QUORUM_RETRIES = 4

    def _await_quorum(self, oid: int, ds_i: int) -> None:
        """Synchronous W-of-R write replication on the virtual clock: the
        writer waits for ``write_quorum - 1`` replica acks, one remote hop
        each, serialized on the app clock like the live store's ack waits
        (the wait counts as stall, so ``end_t = t - stall`` stays anchored
        on the quorum-free schedule).  An unreachable quorum retries with
        exponential backoff — ``_advance_faults`` runs between attempts so
        a scheduled heal can unblock the wait — and degrades to sloppy
        replication when retries exhaust (the missed replicas resync at
        readmission; the live store raises ``QuorumUnreachable`` instead)."""
        reps = self.store.replicas_of(oid)
        want = min(self.write_quorum, len(reps))
        if want <= 1:
            return
        backoff = max(self.latency.failover_detect, self.latency.disk_load)
        for attempt in range(self.MAX_QUORUM_RETRIES + 1):
            reachable = [r for r in reps
                         if r not in self.dead and r not in self.cut]
            if len(reachable) >= want:
                wait = (want - 1) * self.latency.remote_hop
                self.t += wait
                self.stall_seconds += wait
                self.quorum_writes += 1
                # W-1 synchronous replica acks per write — the same
                # definition the live store's counter uses
                self.quorum_acks += want - 1
                for r in reachable:
                    if r == ds_i:
                        continue
                    e = self.caches[r].get(oid)
                    if e is not None:
                        e.dirty = True  # replicated write dirties the copy
                return
            if attempt == self.MAX_QUORUM_RETRIES:
                break
            pause = backoff * (2 ** attempt)
            self.t += pause
            self.stall_seconds += pause
            self.quorum_retries += 1
            self._advance_faults()
        self.quorum_failures += 1
        if self.tracer is not None:
            self.tracer.instant("quorum-unreachable", t=self.t, oid=oid,
                                wanted=want)

    # -- the two event kinds -------------------------------------------------

    def predict(self, oids: Sequence[int], origin: str = "",
                rfo: frozenset = frozenset(),
                priorities: Optional[dict] = None) -> None:
        """Predictor emitted ``oids`` at the current virtual time: schedule
        a disk load on each one's own Data Service unless already resident
        or in flight (request coalescing).  Dispatch overhead charges at
        the configured granularity — per oid, or per Data-Service batch —
        by delaying the *issue* time of the loads (the submitting side
        serializes task starts; the application clock itself is not
        advanced, prefetch dispatch runs on background threads), and every
        dispatch additionally queues for one of the bounded executor-pool
        workers.  ``rfo`` oids land dirty (read-for-ownership);
        ``priorities`` orders batched per-service dispatch and feeds the
        mean-priority artifact column."""
        self._advance_faults()
        if not self.rfo_enabled:
            rfo = frozenset()
        if priorities:
            self._prio_sum += sum(priorities.values())
            self._prio_n += len(priorities)
        if self.dispatch == "batch":
            self._predict_batched(oids, origin=origin, rfo=rfo,
                                  priorities=priorities)
            return
        tr = self.tracer
        overhead = self.latency.dispatch_overhead
        for i, oid in enumerate(oids):
            ds_i = self._route_prefetch(oid)
            if ds_i is None:
                continue  # no reachable replica: skip, demand surfaces it
            # promote completions up to the app clock only — a load issued
            # earlier in this very emission is *in flight*, not resident
            self._materialize(ds_i, self.t)
            self.prefetch_requests += 1
            self.batch_dispatches += 1  # per-oid: every oid is a submission
            if tr is not None:
                tr.predicted([oid], origin, t=self.t)
                tr.dispatched([oid], ds_i, tr.new_batch(), t=self.t)
            cache = self.caches[ds_i]
            if oid in cache:
                # policy bump only (a prefetch touch must not count as the
                # application using the line), keep source/used
                self.policies[ds_i].note_access(oid, prefetch=True)
                if tr is not None:
                    tr.suppressed([oid], ds_i, t=self.t)
                continue
            if oid in self.inflight[ds_i]:
                if tr is not None:
                    tr.suppressed([oid], ds_i, t=self.t)
                continue
            slot, issue_t = self._exec_issue(self.t + (i + 1) * overhead)
            start, done = self.disks[ds_i].schedule(issue_t)
            self._exec_slots[slot] = done  # worker busy until the load lands
            self.inflight[ds_i][oid] = (start, done)
            if self.active_tenant:
                self._pf_owner[oid] = self.active_tenant
            if oid in rfo:
                self._rfo_pending[ds_i].add(oid)
            self.prefetch_loads += 1
            if tr is not None:
                tr.claimed([oid], ds_i, t=issue_t)
                tr.loaded([oid], ds_i, self.disks[ds_i].last_slot,
                          issue_t, start, done)

    def _predict_batched(self, oids: Sequence[int], origin: str = "",
                         rfo: frozenset = frozenset(),
                         priorities: Optional[dict] = None) -> None:
        """The batched mirror of ``ObjectStore.prefetch_batch``: group by
        owning Data Service in predicted-need order, dedupe each group
        against residency and in-flight loads before submission, then issue
        the surviving loads as one pipelined batch on the service's disk.
        With ``priorities`` the groups dispatch highest-priority-first
        (the live path orders identically)."""
        groups: dict[int, list[int]] = {}
        for oid in oids:
            ds_i = self._route_prefetch(oid)
            if ds_i is None:
                continue  # no reachable replica: skip, demand surfaces it
            groups.setdefault(ds_i, []).append(oid)
        ordered = list(groups.items())
        if priorities:
            ordered.sort(key=lambda kv: -max(
                (priorities.get(o, 0.0) for o in kv[1]), default=0.0))
        tr = self.tracer
        overhead = self.latency.dispatch_overhead
        submitted = 0
        for ds_i, batch in ordered:
            self._materialize(ds_i, self.t)
            if tr is not None:
                tr.predicted(batch, origin, t=self.t)
                tr.dispatched(batch, ds_i, tr.new_batch(), t=self.t)
            todo: list[int] = []
            claimed: set[int] = set()
            cache = self.caches[ds_i]
            for oid in batch:
                self.prefetch_requests += 1
                if oid in cache:
                    self.policies[ds_i].note_access(oid, prefetch=True)
                    self.dedup_suppressed += 1
                elif oid in self.inflight[ds_i] or oid in claimed:
                    self.dedup_suppressed += 1
                else:
                    claimed.add(oid)
                    todo.append(oid)
            if tr is not None:
                lost = [o for o in batch if o not in claimed]
                if lost:
                    tr.suppressed(lost, ds_i, t=self.t)
            if not todo:
                continue
            submitted += 1
            self.batch_dispatches += 1
            slot, issue_t = self._exec_issue(self.t + submitted * overhead)
            disk = self.disks[ds_i]
            batch_done = issue_t
            for oid in todo:
                start, done = disk.schedule(issue_t)
                batch_done = max(batch_done, done)
                self.inflight[ds_i][oid] = (start, done)
                if self.active_tenant:
                    self._pf_owner[oid] = self.active_tenant
                if oid in rfo:
                    self._rfo_pending[ds_i].add(oid)
                self.prefetch_loads += 1
                if tr is not None:
                    tr.claimed([oid], ds_i, t=issue_t)
                    tr.loaded([oid], ds_i, disk.last_slot, issue_t, start, done)
            # the batch task occupies its executor worker until its last
            # load is ready (claim + slot wait + disk service, like the
            # live _load_lane worker)
            self._exec_slots[slot] = batch_done

    def access(self, oid: int, write: bool = False) -> None:
        """Application touches ``oid`` (read navigation, or field update
        when ``write``): redirect execution if needed, then wait out
        whatever part of the disk load prefetching did not hide.  A write
        to an uncached object write-allocates — the same demand load a read
        pays — and always leaves the line dirty."""
        self._advance_faults()
        ds_i = self._route(oid)
        if self.cur_ds != ds_i:
            self.t += self.latency.remote_hop
            self.cur_ds = ds_i
            self.remote_hops += 1
        self._materialize(ds_i, self.t)
        self.n_access += 1
        if write:
            self.writes += 1
        needed_at = self.t
        tr = self.tracer
        # per-service disk time (straggler scales fold in; exact x*1.0
        # multiplication keeps no-fault accounting byte-identical)
        disk_s = self.disks[ds_i]._disk_load
        cache = self.caches[ds_i]
        entry = cache.get(oid)
        owned = False  # did this very access acquire write ownership?
        if entry is not None:
            # resident: ready-at <= needed-at. Timely iff prefetching (not a
            # prior demand load) put it there.
            self.policies[ds_i].note_access(oid)
            if entry.source == "pf":
                if not entry.used:
                    self.hidden_seconds += disk_s
                self.timely += 1
            entry.used = True
            self._pf_owner.pop(oid, None)  # used: no longer an unused-pf line
            if write:
                self.write_hits += 1
            self.stall_hist.record(0.0)
            if tr is not None:
                tr.demand(oid, ds_i, needed_at, 0.0, False,
                          disk_s, t=needed_at)
        elif oid in self.inflight[ds_i]:
            # predicted, still in flight: the app waits out the remainder
            # (a straggling in-flight load is exactly what hedging cuts —
            # a fresh demand read on another replica can beat it)
            _start, done = self.inflight[ds_i].pop(oid)
            orig = ds_i
            ds_i, done = self._hedge_race(oid, ds_i, needed_at, done)
            self.cur_ds = ds_i
            stall = done - needed_at
            self.stall_seconds += stall
            self.hidden_seconds += max(0.0, disk_s - stall)
            self.t = done
            self.partial += 1
            self._pf_owner.pop(oid, None)
            self._insert(ds_i, oid, "pf", used=True)
            entry = self.caches[ds_i].get(oid)
            if ds_i != orig and oid in self._rfo_pending[orig]:
                # the RFO mark travels with the object, not the replica
                self._rfo_pending[orig].discard(oid)
                self._rfo_pending[ds_i].add(oid)
            self._land_rfo(ds_i, oid)  # an RFO load lands dirty (owned)
            self.stall_hist.record(stall)
            if tr is not None:
                tr.demand(oid, ds_i, needed_at, stall, False,
                          disk_s, t=done)
        else:
            # unpredicted (or evicted): full demand load, queueing behind
            # whatever the prefetcher has piled onto this service's disk
            # (with hedging armed, a slow primary races a second replica)
            ds_i, _start, done = self._maybe_hedge(oid, ds_i, needed_at)
            self.cur_ds = ds_i  # execution follows the replica that answered
            stall = done - needed_at
            self.stall_seconds += stall
            self.t = done
            self.demand_loads += 1
            if oid in self._evicted_ever:
                self.thrash_misses += 1
            self._insert(ds_i, oid, "demand", used=True)
            entry = self.caches[ds_i].get(oid)
            owned = True  # write-allocate acquires ownership with the load
            self.stall_hist.record(stall)
            if tr is not None:
                tr.demand(oid, ds_i, needed_at, stall, True,
                          disk_s, t=done)
        if write and entry is not None:
            if not entry.dirty and not owned:
                # ownership upgrade: writing a resident-but-clean line pays
                # a round trip to acquire write ownership on the app clock —
                # the cost an RFO prefetch (dirty-allocated landing) removes
                self.t += self.latency.remote_hop
                self.stall_seconds += self.latency.remote_hop
                self.ownership_upgrades += 1
            entry.dirty = True
        if write:
            self._note_missed_replicas(oid, ds_i)
            if self.write_quorum > 1:
                self._await_quorum(oid, ds_i)
        self.t += self.latency.think

    def write(self, oid: int) -> None:
        self.access(oid, write=True)


@dataclass
class ReplayResult:
    app: str
    workload: str
    predictor: str
    cache_capacity: int
    policy: str
    shared_budget: bool
    dispatch: str
    precision: Optional[float]
    recall: Optional[float]
    evaluated: bool
    coverage: float
    timely_coverage: float
    partial_hide: float
    stall_seconds: float
    baseline_stall_seconds: float
    stall_saved_pct: float
    true_positives: int
    false_positives: int
    false_negatives: int
    evictions: int
    thrash_misses: int
    prefetch_loads: int
    writes: int
    write_hits: int
    dirty_evictions: int
    flushed_writes: int
    batch_dispatches: int
    dedup_suppressed: int
    # per-operation stall distribution (exact percentiles over every demand
    # event on the virtual clock: 0.0 = fully hidden / resident, up to a
    # full queued demand load) — the tail metrics the multi-tenant
    # north-star reports
    stall_p50_s: float = 0.0
    stall_p99_s: float = 0.0
    stall_p999_s: float = 0.0
    # virtual stalls re-expressed in calibrated wall seconds (the fitted
    # per-app scale from artifacts/predict/calibration.csv; 1.0 = unfitted)
    calib_scale: float = 1.0
    calibrated_stall_s: float = 0.0
    # topology + failure regime the row was replayed under
    placement: str = "round-robin"
    replication: int = 1
    write_quorum: int = 1
    scenario: str = "no-fault"
    failovers: int = 0
    overhead: dict = field(default_factory=dict)

    def row(self) -> dict:
        out = dict(self.__dict__)
        out.update(out.pop("overhead"))
        return out


def replay_baseline(
    trace: RecordedTrace, store, latency: LatencyModel = REPLAY, cache_capacity: int = 0,
    policy: str = DEFAULT_POLICY, shared_budget: bool = False, scenario=None,
    write_quorum: int = 1
) -> VirtualReplay:
    """The no-prefetch reference: every cold (or thrashed-out) demand event
    pays the full disk load (writes included — write-allocate + dirty
    evictions).  Same trace, same clock, same eviction policy, no
    predictions.  A fault ``scenario`` applies to the baseline too — the
    reference for a faulted replay is the same faults without prefetch
    (likewise ``write_quorum``: the reference prices the same consistency)."""
    engine = VirtualReplay(store, latency=latency, cache_capacity=cache_capacity,
                           policy=policy, shared_budget=shared_budget,
                           scenario=scenario, write_quorum=write_quorum)
    for ev in as_events(trace.events):
        if ev.kind == ACCESS:
            engine.access(ev.oid)
        elif ev.kind == WRITE:
            engine.write(ev.oid)
    return engine


def replay(
    trace: RecordedTrace,
    predictor: Predictor,
    store,
    reg,
    latency: LatencyModel = REPLAY,
    cache_capacity: int = 0,
    policy: str = DEFAULT_POLICY,
    shared_budget: bool = False,
    dispatch: str = "per-oid",
    baseline_stall_seconds: Optional[float] = None,
    tracer=None,
    calibration=None,
    scenario=None,
    rfo: bool = True,
    write_quorum: int = 1,
) -> ReplayResult:
    """Drive ``predictor`` through the recorded event stream on the virtual
    clock and score what its prefetches would have hidden.  Pass a
    ``repro_torch.obs.Tracer`` to collect full lifecycle spans (virtual
    timestamps), a ``predict.calibration.Calibration`` to report the stalls
    in calibrated wall seconds too, and a ``pos.latency.FailureScenario``
    to replay under a straggler/crash regime (the store's placement +
    replication are read off ``store`` itself — ``rebuild_placement``
    first to sweep policies)."""
    predictor.attach(store, reg)
    engine = VirtualReplay(store, latency=latency, cache_capacity=cache_capacity,
                           policy=policy, shared_budget=shared_budget, dispatch=dispatch,
                           tracer=tracer, scenario=scenario, rfo_enabled=rfo,
                           write_quorum=write_quorum)
    name = predictor.name
    predicted: set[int] = set()
    accessed: set[int] = set()
    n_access, covered = 0, 0
    for ev in as_events(trace.events):
        if ev.kind == METHOD_ENTRY:
            out = predictor.on_method_entry(ev.method_key, ev.oid)
            predicted.update(out)
            rfo_oids, priorities = predictor.take_emission_meta()
            engine.predict(out, origin=f"{name}:{ev.method_key}",
                           rfo=rfo_oids, priorities=priorities or None)
        else:
            oid = ev.oid
            n_access += 1
            if oid in predicted:
                covered += 1
            accessed.add(oid)
            if ev.kind == WRITE:
                engine.write(oid)
                out = predictor.on_write(oid, store.cls_of(oid))
            else:
                engine.access(oid)
                out = predictor.on_access(oid, store.cls_of(oid))
            predicted.update(out)
            rfo_oids, priorities = predictor.take_emission_meta()
            engine.predict(out, origin=f"{name}:on_access",
                           rfo=rfo_oids, priorities=priorities or None)
    if tracer is not None:
        # lifecycle invariant at end of run: still-active spans (predicted
        # or resident-but-never-demanded) terminate as dropped
        tracer.drop_active("replay-end", t=engine.t)
    if baseline_stall_seconds is None:
        baseline_stall_seconds = replay_baseline(
            trace, store, latency=latency, cache_capacity=cache_capacity,
            policy=policy, shared_budget=shared_budget, scenario=scenario,
            write_quorum=write_quorum,
        ).stall_seconds
    saved = (
        100.0 * (1.0 - engine.stall_seconds / baseline_stall_seconds)
        if baseline_stall_seconds
        else 0.0
    )
    acc = prefetch_accuracy(predicted, accessed)
    overhead = predictor.overhead.snapshot()
    # timeliness costs land on the ledger snapshot (Hybrid derives its
    # ledger from its parts, so mutate the dict, not the property)
    overhead["late_predictions"] = engine.partial
    overhead["evicted_before_use"] = engine.evicted_before_use
    overhead["hidden_seconds"] = engine.hidden_seconds
    overhead["protected_evictions"] = engine.protected_evictions
    overhead["batch_dispatches"] = engine.batch_dispatches
    overhead["dedup_suppressed"] = engine.dedup_suppressed
    # static-optimizer accounting on the virtual clock: RFO prefetch
    # landings, write-to-clean ownership upgrades the app paid anyway,
    # modeled executor-pool waits, and the mean static priority seen
    overhead["rfo_prefetches"] = engine.rfo_prefetches
    overhead["ownership_upgrades"] = engine.ownership_upgrades
    overhead["exec_delayed"] = engine.exec_delayed
    overhead["hint_priority_mean"] = (
        round(engine._prio_sum / engine._prio_n, 4) if engine._prio_n else 0.0
    )
    # what the instruments themselves cost this replay (histogram recording
    # + span bookkeeping), charged to the ledger like any other overhead
    overhead["obs_seconds"] = engine.obs_meter.seconds
    overhead["obs_events"] = engine.obs_meter.events
    # recovery accounting (partition/readmission/quorum/hedging regimes)
    overhead["readmissions"] = engine.readmissions
    overhead["resync_lines"] = engine.resync_lines
    overhead["hedged_reads"] = engine.hedged_reads
    overhead["hedge_wins"] = engine.hedge_wins
    overhead["quorum_writes"] = engine.quorum_writes
    overhead["quorum_acks"] = engine.quorum_acks
    overhead["quorum_retries"] = engine.quorum_retries
    overhead["quorum_failures"] = engine.quorum_failures
    p50, p99, p999 = engine.stall_hist.percentiles((0.5, 0.99, 0.999))
    scale = (calibration.scale_for(_calibration_app_key(trace.app_name, trace.workload))
             if calibration is not None else 1.0)
    return ReplayResult(
        app=trace.app_name,
        workload=trace.workload,
        predictor=predictor.name,
        cache_capacity=cache_capacity,
        policy=policy,
        dispatch=dispatch,
        # the engine's effective mode, not the requested flag: at capacity 0
        # there is no budget to share and the row must say so
        shared_budget=engine.shared_budget,
        precision=acc["precision"],
        recall=acc["recall"],
        evaluated=acc["evaluated"],
        coverage=covered / max(1, n_access),
        timely_coverage=engine.timely / max(1, engine.n_access),
        partial_hide=engine.partial / max(1, engine.n_access),
        stall_seconds=engine.stall_seconds,
        baseline_stall_seconds=baseline_stall_seconds,
        stall_saved_pct=saved,
        true_positives=acc["true_positives"],
        false_positives=acc["false_positives"],
        false_negatives=acc["false_negatives"],
        evictions=engine.evictions,
        thrash_misses=engine.thrash_misses,
        prefetch_loads=engine.prefetch_loads,
        writes=engine.writes,
        write_hits=engine.write_hits,
        dirty_evictions=engine.dirty_evictions,
        flushed_writes=engine.flushed_writes,
        batch_dispatches=engine.batch_dispatches,
        dedup_suppressed=engine.dedup_suppressed,
        stall_p50_s=p50 or 0.0,
        stall_p99_s=p99 or 0.0,
        stall_p999_s=p999 or 0.0,
        calib_scale=scale,
        calibrated_stall_s=engine.stall_seconds * scale,
        placement=getattr(store, "placement_name", "round-robin"),
        replication=getattr(store, "replication", 1),
        write_quorum=engine.write_quorum,
        scenario=scenario.name if scenario is not None else "no-fault",
        failovers=engine.failovers,
        overhead=overhead,
    )


def _calibration_app_key(app: str, workload: str) -> str:
    """Catalog key a result calibrates under — the mutating bank traversal
    is fitted separately (mirrors ``benchmarks/calibrate_latency.py``)."""
    return "bank_write" if workload == "setAllTransCustomers" else app


def evaluate_workload(
    wl: Workload,
    modes: Optional[Sequence[str]] = None,
    rop_depth: int = 2,
    config: Optional[SessionConfig] = None,
    cache_capacities: Sequence[int] = (0,),
    policies: Sequence[str] = (DEFAULT_POLICY,),
    shared_budget: bool = False,
    dispatch_modes: Sequence[str] = ("per-oid",),
    latency: LatencyModel = REPLAY,
    recorded: Optional[tuple[POSClient, int, list[RecordedTrace]]] = None,
    calibration=None,
    placement: str = "round-robin",
    replication: int = 1,
    scenarios: Sequence[str] = ("no-fault",),
    rfo: bool = True,
    write_quorums: Sequence[int] = (1,),
) -> list[ReplayResult]:
    """Record (train + eval runs), then replay every requested predictor
    under every (cache capacity, eviction policy, write quorum, dispatch
    mode, failure scenario) — miners warmed on the train run, everyone
    scored on the eval run.  ``rop_depth`` is only consulted when no ``config`` is supplied;
    pass ``recorded`` to reuse traces from ``record_catalog``.  Recording
    is placement-independent (the event stream is oids in program order),
    so one recorded trace replays under every placement/replication via
    ``rebuild_placement``; a crash scenario's crash time is anchored at a
    fraction of the *no-fault* baseline's completion time so the crash
    lands mid-run for every app."""
    from repro_torch.pos.latency import make_scenario

    client, _root, traces = recorded if recorded is not None else record_workload(wl, runs=2)
    train, eval_ = traces[0], traces[-1]
    store = client.store
    if (placement != store.placement_name
            or replication != store.replication):
        store.rebuild_placement(placement, replication=replication)
    reg = client.logic_module.registered[wl.name]
    cfg = config if config is not None else SessionConfig(rop_depth=rop_depth)
    results = []
    for capacity in cache_capacities:
        for policy in policies:
            for wq in write_quorums:
                # the no-prefetch reference never dispatches: one baseline
                # serves every dispatch mode of this (capacity, policy,
                # quorum) cell
                nofault_baseline = replay_baseline(
                    eval_, store, latency=latency, cache_capacity=capacity,
                    policy=policy, shared_budget=shared_budget,
                    write_quorum=wq,
                )
                # crash-time anchor: the stall-free floor (think + hops) is
                # the one duration every replay of this cell shares — a
                # fraction of the *baseline* end would fall past the end of
                # a well-prefetched run (which finishes several times
                # faster) and never fire.  Quorum waits count as stall, so
                # the anchor is also quorum-invariant: every scenario fires
                # its faults at the same virtual instant across quorums.
                end_t = nofault_baseline.t - nofault_baseline.stall_seconds
                for scenario_name in scenarios:
                    scenario = make_scenario(scenario_name, end_t=end_t)
                    if not scenario.is_fault:
                        scenario = None
                        baseline = nofault_baseline.stall_seconds
                    else:
                        baseline = replay_baseline(
                            eval_, store, latency=latency,
                            cache_capacity=capacity,
                            policy=policy, shared_budget=shared_budget,
                            scenario=scenario, write_quorum=wq,
                        ).stall_seconds
                    for dispatch in dispatch_modes:
                        for mode in modes if modes is not None else available(kind="pos"):
                            predictor = make_pos_predictor(mode, config=cfg)
                            predictor.warm(train.accesses)
                            results.append(
                                replay(
                                    eval_,
                                    predictor,
                                    store,
                                    reg,
                                    latency=latency,
                                    cache_capacity=capacity,
                                    policy=policy,
                                    shared_budget=shared_budget,
                                    dispatch=dispatch,
                                    baseline_stall_seconds=baseline,
                                    calibration=calibration,
                                    scenario=scenario,
                                    rfo=rfo,
                                    write_quorum=wq,
                                )
                            )
    return results


def evaluate_apps(
    apps: Sequence[str] = ("bank", "bank_write", "wordcount", "kmeans"),
    modes: Optional[Sequence[str]] = None,
    rop_depth: int = 2,
    cache_capacities: Sequence[int] = (0,),
    policies: Sequence[str] = (DEFAULT_POLICY,),
    shared_budget: bool = False,
    dispatch_modes: Sequence[str] = ("per-oid",),
    latency: LatencyModel = REPLAY,
    trace_cache: Optional[str] = "default",
    calibration=None,
    calibrated: bool = False,
    placement: str = "round-robin",
    replication: int = 1,
    scenarios: Sequence[str] = ("no-fault",),
    rfo: bool = True,
    write_quorums: Sequence[int] = (1,),
) -> list[ReplayResult]:
    """``calibrated=True`` replays each app under its calibrated latency
    model (``calibration.calibrated_model``) instead of the raw REPLAY
    constants — virtual seconds then read directly as predicted wall
    seconds.  Off by default: the committed baseline.csv is recorded in
    raw virtual units."""
    catalog = _catalog()
    for name in apps:
        if name not in catalog:
            raise KeyError(f"unknown app {name!r}; catalog: {sorted(catalog)}")
    if calibration is None:
        # one loader, one source of truth: the fitted per-app scales come
        # from artifacts/predict/calibration.csv (identity when unfitted)
        from .calibration import load_calibration

        calibration = load_calibration()
    recorded = record_catalog([catalog[name] for name in apps],
                              cache_dir=_resolve_trace_cache(trace_cache))
    out: list[ReplayResult] = []
    wl_calibration = calibration
    for name in apps:
        wl_latency = latency
        if calibrated:
            from .calibration import Calibration, calibrated_model

            # catalog keys are the calibration table's app keys; the clock
            # itself is now in wall units, so the post-hoc column scale is
            # identity (calibrated_stall_s == stall_seconds, no re-scaling)
            wl_latency = calibrated_model(name, base=latency,
                                          calibration=calibration)
            wl_calibration = Calibration()
        out.extend(
            evaluate_workload(
                catalog[name],
                modes=modes,
                rop_depth=rop_depth,
                cache_capacities=cache_capacities,
                policies=policies,
                shared_budget=shared_budget,
                dispatch_modes=dispatch_modes,
                latency=wl_latency,
                recorded=recorded[name],
                calibration=wl_calibration,
                placement=placement,
                replication=replication,
                scenarios=scenarios,
                rfo=rfo,
                write_quorums=write_quorums,
            )
        )
    return out


# ---------------------------------------------------------------------------
# reporting / artifacts
# ---------------------------------------------------------------------------


_COLUMNS = (
    ("app", "{}"),
    ("workload", "{}"),
    ("predictor", "{}"),
    ("cache_capacity", "{}"),
    ("policy", "{}"),
    ("dispatch", "{}"),
    ("placement", "{}"),
    ("scenario", "{}"),
    ("precision", "{:.3f}"),
    ("recall", "{:.3f}"),
    ("coverage", "{:.3f}"),
    ("timely_coverage", "{:.3f}"),
    ("partial_hide", "{:.3f}"),
    ("stall_seconds", "{:.4f}"),
    ("stall_p50_s", "{:.4f}"),
    ("stall_p99_s", "{:.4f}"),
    ("stall_p999_s", "{:.4f}"),
    ("calibrated_stall_s", "{:.4f}"),
    ("baseline_stall_seconds", "{:.4f}"),
    ("stall_saved_pct", "{:.1f}"),
    ("evictions", "{}"),
    ("thrash_misses", "{}"),
    ("writes", "{}"),
    ("write_hits", "{}"),
    ("flushed_writes", "{}"),
    ("true_positives", "{}"),
    ("false_positives", "{}"),
    ("false_negatives", "{}"),
    ("table_bytes", "{}"),
    ("monitor_events", "{}"),
    ("late_predictions", "{}"),
    ("train_seconds", "{:.4f}"),
)

#: every flattened ReplayResult field, in CSV column order
CSV_COLUMNS = tuple(k for k, _ in _COLUMNS) + (
    "evaluated",
    "prefetch_loads",
    "predictions",
    "evicted_before_use",
    "hidden_seconds",
    "dirty_evictions",
    "protected_evictions",
    "shared_budget",
    "batch_dispatches",
    "dedup_suppressed",
    "calib_scale",
    "obs_seconds",
    "obs_events",
    # topology + failure-regime columns (placement/scenario are already in
    # _COLUMNS): keyed rows stay unique on the legacy key at the defaults
    "replication",
    "failovers",
    # partition-tolerant recovery columns: write-quorum pricing, hedged
    # demand reads, and readmission/anti-entropy accounting
    "write_quorum",
    "readmissions",
    "resync_lines",
    "hedged_reads",
    "hedge_wins",
    "quorum_writes",
    "quorum_acks",
    "quorum_retries",
    "quorum_failures",
    # static-optimizer columns (core.opt): read-for-ownership landings,
    # prefix-clipped collection expansions, mean static dispatch priority,
    # write-to-clean ownership round trips, and modeled executor-pool waits
    "rfo_prefetches",
    "truncated_hints",
    "hint_priority_mean",
    "ownership_upgrades",
    "exec_delayed",
)


def _fmt(value, fmt: str) -> str:
    return "-" if value is None else fmt.format(value)


def format_table(results: Sequence[ReplayResult]) -> str:
    rows = [[_fmt(r.row()[k], fmt) for k, fmt in _COLUMNS] for r in results]
    header = [k for k, _ in _COLUMNS]
    widths = [max(len(h), *(len(row[i]) for row in rows)) if rows else len(h)
              for i, h in enumerate(header)]
    lines = ["  ".join(h.ljust(w) for h, w in zip(header, widths))]
    for row in rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
    return "\n".join(lines)


def write_csv(results: Sequence[ReplayResult], path: str) -> str:
    """Write the flattened result rows as a CSV artifact (undefined ratios
    become empty cells, never phantom zeros)."""
    import csv

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(CSV_COLUMNS), extrasaction="ignore")
        writer.writeheader()
        for r in results:
            row = r.row()
            writer.writerow({k: ("" if row.get(k) is None else row.get(k, "")) for k in CSV_COLUMNS})
    return path


def _loadsim_main(args) -> None:
    """``--tenants N``: the virtual-clock mirror of benchmarks/loadgen.py.
    Deterministic for a given argument set — the committed loadgen.csv's
    virtual rows are byte-reproducible (wall_s cells stay empty)."""
    from .loadsim import run_loadsim, write_loadgen_csv

    capacities = [int(c) for c in args.cache_capacity.split(",") if c != ""]
    dispatch = args.dispatch.split(",")[0].strip() or "batch"
    report = run_loadsim(
        tenants=args.tenants, arrival=args.arrival, jobs=args.jobs,
        seed=args.seed, mode=args.mode, dispatch=dispatch,
        cache_capacity=capacities[0] if capacities else 128,
        shared_budget=args.shared_budget or not capacities,
        policy=args.cache_policy.split(",")[0],
        max_outstanding=args.max_outstanding,
        admission_threshold=args.admission_threshold,
        scenario=args.scenario.split(",")[0].strip() or "no-fault",
        replication=args.replication,
        write_quorum=int(args.write_quorum.split(",")[0] or 1),
    )
    agg = report.rows()[-1]
    print(f"# loadsim tenants={report.tenants} arrival={report.arrival} "
          f"mode={report.mode} dispatch={report.dispatch} "
          f"scenario={report.scenario}")
    print(f"#   ops={agg['ops']} mean_stall={agg['stall_mean_s']}s "
          f"fairness={report.fairness_ratio:.2f} "
          f"evicted_before_use={agg['evicted_before_use']} "
          f"shed={agg['admission_shed']} failovers={report.failovers}")
    if not args.no_csv:
        path = os.path.join(args.out, "loadgen.csv")
        write_loadgen_csv(path, report.rows(), append=args.append)
        print(f"# wrote {path} ({len(report.rows())} rows)")


def main(argv: Optional[list[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--apps", default="bank,bank_write,wordcount,kmeans,oo7,pga",
                    help="comma-separated app names from the catalog")
    ap.add_argument("--modes", default=None,
                    help="comma-separated predictor names (default: all registered)")
    ap.add_argument("--rop-depth", type=int, default=2)
    ap.add_argument("--cache-capacity", default="0",
                    help="comma-separated per-DS cache capacities to sweep (0 = unbounded)")
    ap.add_argument("--cache-policy", default=DEFAULT_POLICY,
                    help="comma-separated eviction policies to sweep "
                         "(lru, fifo, clock, lfu, prefetch-aware)")
    ap.add_argument("--shared-budget", action="store_true",
                    help="treat --cache-capacity as one global line budget drawn "
                         "on by all Data Services (policy-mediated stealing) "
                         "instead of a per-service capacity")
    ap.add_argument("--dispatch", default="per-oid,batch",
                    help="comma-separated dispatch modes to sweep (per-oid = one "
                         "executor submission per predicted oid; batch = one "
                         "deduped request per Data Service)")
    ap.add_argument("--placement", default="round-robin",
                    help="object placement policy to replay under "
                         "(round-robin, consistent-hash, locality); the "
                         "recorded traces re-place via rebuild_placement")
    ap.add_argument("--replication", type=int, default=1,
                    help="replication factor R (primary + ring successors); "
                         "crash scenarios need R >= 2 to complete")
    ap.add_argument("--scenario", default="no-fault",
                    help="comma-separated failure scenarios to sweep "
                         "(no-fault, straggler, crash, partition, "
                         "crash+revive, straggler+hedge)")
    ap.add_argument("--write-quorum", default="1",
                    help="comma-separated write quorums W to sweep: each "
                         "dirty write waits for W-of-R replica acks on the "
                         "app clock (1 = async/sloppy replication)")
    ap.add_argument("--calibrated", action="store_true",
                    help="replay each app under its calibrated latency model "
                         "(fitted scales from artifacts/predict/calibration.csv) "
                         "so virtual stalls read directly as predicted wall seconds")
    ap.add_argument("--no-rfo", action="store_true",
                    help="ignore read-for-ownership hint marks: prefetches "
                         "land clean and writes to them pay the ownership "
                         "round trip (the A/B control for core.opt pass 1)")
    ap.add_argument("--no-trace-cache", action="store_true",
                    help="always re-record workload traces instead of reusing "
                         "the disk-memoized ones under artifacts/predict/traces")
    ap.add_argument("--out", default="artifacts/predict",
                    help="directory for the CSV artifact (replay.csv)")
    ap.add_argument("--no-csv", action="store_true", help="print tables only")
    ap.add_argument("--fast", action="store_true",
                    help="only the fastest-to-trace apps (incl. the mutating bank run)")
    ap.add_argument("--tenants", type=int, default=0,
                    help="run the multi-tenant load simulation instead of the "
                         "single-tenant sweep: N concurrent sessions over one "
                         "shared store on the virtual clock (predict.loadsim); "
                         "writes <out>/loadgen.csv")
    ap.add_argument("--arrival", default="closed",
                    help="loadsim arrival process: 'closed' (exponential think "
                         "between jobs) or 'poisson:RATE' (open, aggregate RATE "
                         "jobs/s split across tenants)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="loadsim jobs per tenant")
    ap.add_argument("--mode", default="capre",
                    help="loadsim predictor mode for every tenant")
    ap.add_argument("--max-outstanding", type=int, default=0,
                    help="loadsim admission-control bound (0 = unbounded); "
                         "mirrors PrefetchRuntime.admit on the modeled pool")
    ap.add_argument("--admission-threshold", type=float, default=0.0,
                    help="static priority that bypasses a full admission queue")
    ap.add_argument("--seed", type=int, default=0,
                    help="loadsim RNG seed (mix assignment, arrivals, think)")
    ap.add_argument("--append", action="store_true",
                    help="append loadsim rows to an existing loadgen.csv "
                         "(CI matrix legs share one artifact)")
    args = ap.parse_args(argv)
    if args.tenants > 0:
        _loadsim_main(args)
        return
    apps = ("bank", "bank_write", "wordcount", "kmeans") if args.fast else tuple(
        a for a in args.apps.split(",") if a
    )
    modes = tuple(m for m in args.modes.split(",") if m) if args.modes else None
    capacities = tuple(int(c) for c in args.cache_capacity.split(",") if c != "")
    policies = tuple(p for p in args.cache_policy.split(",") if p)
    dispatch_modes = tuple(d for d in args.dispatch.split(",") if d)
    scenarios = tuple(s for s in args.scenario.split(",") if s)
    write_quorums = tuple(int(w) for w in args.write_quorum.split(",") if w)
    results = evaluate_apps(
        apps=apps, modes=modes, rop_depth=args.rop_depth, cache_capacities=capacities,
        policies=policies, shared_budget=args.shared_budget,
        dispatch_modes=dispatch_modes,
        trace_cache=None if args.no_trace_cache else "default",
        calibrated=args.calibrated,
        placement=args.placement, replication=args.replication,
        scenarios=scenarios, rfo=not args.no_rfo,
        write_quorums=write_quorums,
    )
    print(format_table(results))
    if not args.no_csv:
        path = write_csv(results, os.path.join(args.out, "replay.csv"))
        print(f"# wrote {path} ({len(results)} rows)")


if __name__ == "__main__":
    main()
