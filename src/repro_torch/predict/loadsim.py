"""Multi-tenant load simulation on the virtual clock (DESIGN.md §3.10).

``benchmarks/loadgen.py`` drives tens of concurrent live ``Session``s; this
module mirrors the same arrival processes on the deterministic virtual
clock so replay can sweep *hundreds* of tenants in seconds.  One shared
:class:`~repro_torch.predict.evaluate.VirtualReplay` engine is time-multiplexed
across N tenants:

  * **shared contention state** — disks, caches (optionally one
    shared budget), in-flight loads, and the bounded prefetch-executor
    pool are ONE set of structures, so tenant A's prefetch flood queues
    tenant B's demand loads and evicts B's prefetched-but-unused lines
    (charged per-tenant via the engine's ``evicted_by_tenant`` owner map);
  * **per-tenant clock state** — each tenant owns its application clock,
    its current Data Service, and an exact stall histogram; the driver
    swaps them onto the engine around every event and interleaves tenants
    through a min-heap on virtual time (ties break on tenant index, so a
    run is a pure function of its seed);
  * **arrival processes** — ``closed`` (each tenant re-submits after an
    exponential think time) or ``poisson:RATE`` (open: job arrivals are a
    seeded Poisson process of aggregate RATE jobs/s split evenly across
    tenants; a tenant whose previous job overruns queues its next one);
  * **heavy-tailed service mix** — tenant k runs one of the catalog apps
    drawn with weight 1/rank (the cheap app dominates, the expensive tail
    is rare), seeded and deterministic;
  * **admission back-pressure** — the same decision rule as
    ``PrefetchRuntime.admit`` evaluated against the engine's modeled
    executor pool: with ``max_outstanding`` set, an emission arriving
    while that many workers are busy is shed unless its static priority
    clears ``admission_threshold``; sheds are counted per tenant.

Everything here is deterministic: two runs with the same arguments produce
byte-identical CSV rows (no wall-clock cells are written for virtual rows).
"""

from __future__ import annotations

import heapq
import random
from dataclasses import dataclass, field
from typing import Optional, Sequence

from repro_torch.obs import Histogram
from repro_torch.pos.client import POSClient, Session, SessionConfig
from repro_torch.pos.eviction import DEFAULT_POLICY
from repro_torch.pos.latency import REPLAY, LatencyModel
from repro_torch.pos.trace import METHOD_ENTRY, WRITE, as_events

from . import make_pos_predictor
from .evaluate import VirtualReplay, _catalog

#: the committed ``artifacts/predict/loadgen.csv`` schema, shared by the
#: wall-clock harness (``benchmarks/loadgen.py``) and this simulator.
#: ``wall_s`` stays empty on virtual rows so a virtual sweep is
#: byte-reproducible; ``tenant="ALL"`` rows aggregate a whole configuration
#: and carry the fairness ratio.
LOADGEN_COLUMNS = [
    "clock", "tenants", "arrival", "mix", "dispatch", "mode",
    "cache_capacity", "shared_budget", "max_outstanding", "tenant", "app",
    "jobs", "ops", "stall_p50_s", "stall_p99_s", "stall_p999_s",
    "stall_mean_s", "stall_total_s", "evicted_before_use", "admission_shed",
    "fairness_ratio", "wall_s", "seed", "scenario", "failovers",
]

#: default service mix, cheapest-first: heavy-tailed weights 1/rank mean
#: most tenants run the light traversals and a long tail hits the big ones
#: (all five paper apps; bank contributes both its read and write
#: traversals, OO7's deep design tree is the rare expensive tail)
DEFAULT_MIX = ("bank", "wordcount", "kmeans", "bank_write", "pga", "oo7")


def parse_arrival(spec: str) -> tuple[str, float]:
    """``"closed"`` -> ("closed", 0.0); ``"poisson:RATE"`` -> ("poisson",
    RATE) with RATE in aggregate jobs/second."""
    if spec == "closed":
        return "closed", 0.0
    if spec.startswith("poisson:"):
        rate = float(spec.split(":", 1)[1])
        if rate <= 0:
            raise ValueError(f"poisson rate must be > 0, got {rate}")
        return "poisson", rate
    raise ValueError(f"unknown arrival spec {spec!r}; "
                     f"expected 'closed' or 'poisson:RATE'")


def heavy_tailed_weights(n: int) -> list[float]:
    return [1.0 / (i + 1) for i in range(n)]


@dataclass
class _Tenant:
    idx: int
    label: str
    app_key: str
    predictor: object
    events: list  # the app's recorded event stream (one job = one pass)
    jobs_left: int
    arrivals: list[float]  # open mode: precomputed job arrival times
    think_rng: random.Random
    t: float = 0.0
    cur_ds: Optional[int] = None
    pos: int = 0
    jobs_done: int = 0
    shed: int = 0
    hist: Histogram = field(
        default_factory=lambda: Histogram("tenant_stall_s", exact=True))


@dataclass
class TenantResult:
    label: str
    app: str
    jobs: int
    ops: int
    stall_p50_s: float
    stall_p99_s: float
    stall_p999_s: float
    stall_mean_s: float
    stall_total_s: float
    evicted_before_use: int
    admission_shed: int
    failovers: int = 0


@dataclass
class LoadsimReport:
    tenants: int
    arrival: str
    mix: str
    dispatch: str
    mode: str
    cache_capacity: int
    shared_budget: bool
    max_outstanding: int
    seed: int
    per_tenant: list[TenantResult]
    fairness_ratio: float
    total_stall_s: float
    evictions: int
    exec_delayed: int
    scenario: str = "no-fault"
    failovers: int = 0

    def rows(self) -> list[dict]:
        """CSV rows (LOADGEN_COLUMNS): one per tenant + one ALL aggregate."""
        base = {
            "clock": "virtual", "tenants": self.tenants,
            "arrival": self.arrival, "mix": self.mix,
            "dispatch": self.dispatch, "mode": self.mode,
            "cache_capacity": self.cache_capacity,
            "shared_budget": self.shared_budget,
            "max_outstanding": self.max_outstanding,
            "fairness_ratio": "", "wall_s": "", "seed": self.seed,
            "scenario": self.scenario,
        }
        out = []
        for tr in self.per_tenant:
            row = dict(base)
            row.update(
                tenant=tr.label, app=tr.app, jobs=tr.jobs, ops=tr.ops,
                stall_p50_s=round(tr.stall_p50_s, 9),
                stall_p99_s=round(tr.stall_p99_s, 9),
                stall_p999_s=round(tr.stall_p999_s, 9),
                stall_mean_s=round(tr.stall_mean_s, 9),
                stall_total_s=round(tr.stall_total_s, 9),
                evicted_before_use=tr.evicted_before_use,
                admission_shed=tr.admission_shed,
                failovers=tr.failovers,
            )
            out.append(row)
        agg = dict(base)
        ops = sum(tr.ops for tr in self.per_tenant)
        agg.update(
            tenant="ALL", app="mix",
            jobs=sum(tr.jobs for tr in self.per_tenant), ops=ops,
            stall_p50_s="", stall_p99_s="", stall_p999_s="",
            stall_mean_s=round(self.total_stall_s / max(1, ops), 9),
            stall_total_s=round(self.total_stall_s, 9),
            evicted_before_use=sum(tr.evicted_before_use
                                   for tr in self.per_tenant),
            admission_shed=sum(tr.admission_shed for tr in self.per_tenant),
            fairness_ratio=round(self.fairness_ratio, 4),
            failovers=self.failovers,
        )
        out.append(agg)
        return out


def write_loadgen_csv(path: str, rows: Sequence[dict],
                      append: bool = False) -> None:
    import csv
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    exists = append and os.path.exists(path)
    with open(path, "a" if exists else "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=LOADGEN_COLUMNS)
        if not exists:
            w.writeheader()
        for row in rows:
            w.writerow(row)


def _record_shared_catalog(app_keys: Sequence[str], n_services: int = 4
                           ) -> tuple[POSClient, dict[str, list]]:
    """One shared store holding every selected app's object graph (globally
    unique oids — same-app tenants share a database, the multi-tenant
    regime), plus one cold-cache recorded trace per app key.  Mutating
    workloads leave their updates in the shared store, exactly like live
    tenants would."""
    cat = _catalog()
    client = POSClient(n_services=n_services)
    roots: dict[str, int] = {}
    for key in app_keys:
        wl = cat[key]
        if wl.name not in client.logic_module.registered:
            client.register(wl.build_app())
        roots[key] = wl.populate(client.store)
    traces: dict[str, list] = {}
    for key in app_keys:
        wl = cat[key]
        client.store.reset_runtime_state()
        client.store.trace = []
        session = Session(client.store,
                          client.logic_module.registered[wl.name])
        try:
            wl.run_once(session, roots[key])
        finally:
            session.close()
        traces[key] = as_events(list(client.store.trace))
        client.store.trace = None
    return client, traces


def run_loadsim(
    tenants: int = 128,
    arrival: str = "closed",
    jobs: int = 1,
    mix: Sequence[str] = DEFAULT_MIX,
    seed: int = 0,
    mode: str = "capre",
    dispatch: str = "batch",
    cache_capacity: int = 128,
    shared_budget: bool = True,
    policy: str = DEFAULT_POLICY,
    max_outstanding: int = 0,
    admission_threshold: float = 0.0,
    latency: LatencyModel = REPLAY,
    executor_workers: int = 8,
    think_mean_s: float = 2e-3,
    n_services: int = 4,
    scenario: str = "no-fault",
    replication: int = 1,
    write_quorum: int = 1,
) -> LoadsimReport:
    """Simulate ``tenants`` concurrent sessions over one shared store on
    the virtual clock and return per-tenant tail-latency, interference and
    shed accounting.  Fully deterministic for a given argument set.

    A failure ``scenario`` (pos.latency.SCENARIO_NAMES) injects faults on
    the shared engine's clock — the heap driver dispatches events in global
    virtual-time order, so a crash/partition fires at one well-defined
    instant across all tenants and failovers attribute to the tenant whose
    access (or prefetch) tripped over it.  Fault times anchor on the fleet's
    stall-free floor (total think time), which is scenario- and
    quorum-invariant."""
    kind, rate = parse_arrival(arrival)
    mix = list(mix)
    client, traces = _record_shared_catalog(mix, n_services=n_services)
    store = client.store
    if replication != store.replication:
        store.rebuild_placement(store.placement_name,
                                replication=replication)

    rng = random.Random(seed)
    weights = heavy_tailed_weights(len(mix))
    assignment = rng.choices(mix, weights=weights, k=tenants)
    cat = _catalog()
    per_tenant_rate = rate / tenants if kind == "poisson" else 0.0

    sc = None
    if scenario and scenario != "no-fault":
        from repro_torch.pos.latency import make_scenario

        total_access = jobs * sum(
            sum(1 for ev in traces[a] if ev.kind != METHOD_ENTRY)
            for a in assignment)
        sc = make_scenario(scenario, end_t=total_access * latency.think)
    engine = VirtualReplay(
        store, latency=latency, cache_capacity=cache_capacity,
        policy=policy, shared_budget=shared_budget, dispatch=dispatch,
        executor_workers=executor_workers, scenario=sc,
        write_quorum=write_quorum,
    )

    ts: list[_Tenant] = []
    for i in range(tenants):
        app_key = assignment[i]
        wl = cat[app_key]
        reg = client.logic_module.registered[wl.name]
        cfg = SessionConfig(mode=mode, dispatch=dispatch,
                            max_outstanding=max_outstanding,
                            admission_threshold=admission_threshold)
        predictor = make_pos_predictor(mode, config=cfg)
        predictor.attach(store, reg)
        arr_rng = random.Random((seed << 16) ^ (i * 2654435761 & 0xFFFFFFFF))
        arrivals: list[float] = []
        if kind == "poisson":
            t_arr = 0.0
            for _ in range(jobs):
                t_arr += arr_rng.expovariate(per_tenant_rate)
                arrivals.append(t_arr)
        tn = _Tenant(idx=i, label=f"t{i:03d}", app_key=app_key,
                     predictor=predictor, events=traces[app_key],
                     jobs_left=jobs, arrivals=arrivals, think_rng=arr_rng)
        tn.t = arrivals[0] if arrivals else 0.0
        ts.append(tn)

    heap = [(tn.t, tn.idx) for tn in ts if tn.jobs_left > 0 and tn.events]
    heapq.heapify(heap)

    while heap:
        _, idx = heapq.heappop(heap)
        tn = ts[idx]
        # install this tenant's clock view on the shared engine
        engine.t = tn.t
        engine.cur_ds = tn.cur_ds
        engine.stall_hist = tn.hist
        engine.active_tenant = tn.label
        ev = tn.events[tn.pos]
        pred = tn.predictor
        if ev.kind == METHOD_ENTRY:
            out = pred.on_method_entry(ev.method_key, ev.oid)
            rfo_oids, priorities = pred.take_emission_meta()
            _emit(engine, tn, out, f"{pred.name}:{ev.method_key}",
                  rfo_oids, priorities, max_outstanding, admission_threshold)
        elif ev.kind == WRITE:
            engine.write(ev.oid)
            out = pred.on_write(ev.oid, store.cls_of(ev.oid))
            rfo_oids, priorities = pred.take_emission_meta()
            _emit(engine, tn, out, f"{pred.name}:on_access",
                  rfo_oids, priorities, max_outstanding, admission_threshold)
        else:
            engine.access(ev.oid)
            out = pred.on_access(ev.oid, store.cls_of(ev.oid))
            rfo_oids, priorities = pred.take_emission_meta()
            _emit(engine, tn, out, f"{pred.name}:on_access",
                  rfo_oids, priorities, max_outstanding, admission_threshold)
        # read the tenant's clock view back off the engine
        tn.t = engine.t
        tn.cur_ds = engine.cur_ds
        tn.pos += 1
        if tn.pos >= len(tn.events):
            # job complete
            tn.pos = 0
            tn.jobs_done += 1
            tn.jobs_left -= 1
            if tn.jobs_left <= 0:
                continue
            if kind == "closed":
                tn.t += tn.think_rng.expovariate(1.0 / think_mean_s)
            else:
                # open: the next job was already scheduled to arrive; a
                # tenant whose previous job overran starts it late (queued)
                tn.t = max(tn.t, tn.arrivals[tn.jobs_done])
            # a new job starts cold from the root's Data Service
            tn.cur_ds = None
        heapq.heappush(heap, (tn.t, tn.idx))

    engine.active_tenant = ""
    per = []
    means = []
    for tn in ts:
        p50, p99, p999 = tn.hist.percentiles((0.5, 0.99, 0.999))
        ops = tn.hist.count
        mean = tn.hist.sum / ops if ops else 0.0
        if ops:
            means.append(mean)
        per.append(TenantResult(
            label=tn.label, app=tn.app_key, jobs=tn.jobs_done, ops=ops,
            stall_p50_s=p50 or 0.0, stall_p99_s=p99 or 0.0,
            stall_p999_s=p999 or 0.0, stall_mean_s=mean,
            stall_total_s=tn.hist.sum,
            evicted_before_use=engine.evicted_by_tenant.get(tn.label, 0),
            admission_shed=tn.shed,
            failovers=engine.failovers_by_tenant.get(tn.label, 0),
        ))
    fairness = (max(means) / max(min(means), 1e-12)) if means else 0.0
    return LoadsimReport(
        tenants=tenants, arrival=arrival, mix="+".join(mix),
        dispatch=dispatch, mode=mode, cache_capacity=cache_capacity,
        shared_budget=engine.shared_budget, max_outstanding=max_outstanding,
        seed=seed, per_tenant=per, fairness_ratio=fairness,
        total_stall_s=engine.stall_seconds, evictions=engine.evictions,
        exec_delayed=engine.exec_delayed,
        scenario=scenario or "no-fault", failovers=engine.failovers,
    )


def _emit(engine: VirtualReplay, tn: _Tenant, oids, origin: str,
          rfo_oids: frozenset, priorities: dict,
          max_outstanding: int, admission_threshold: float) -> None:
    """Dispatch a tenant's emission through the shared engine, mirroring
    ``PrefetchRuntime.admit``: with ``max_outstanding`` armed, an emission
    arriving while that many modeled executor workers are busy is shed
    unless its best static priority clears the threshold."""
    if not oids:
        return
    if max_outstanding:
        busy = sum(1 for s in engine._exec_slots if s > tn.t)
        best = max(priorities.values()) if priorities else 0.0
        if busy >= max_outstanding and best < admission_threshold:
            tn.shed += 1
            return
    engine.predict(oids, origin=origin, rfo=rfo_oids,
                   priorities=priorities or None)
