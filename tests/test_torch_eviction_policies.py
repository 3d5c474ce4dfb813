"""The port's eviction subsystem (``repro_torch.pos.eviction``) and its
virtual-clock mirror (``repro_torch.predict.evaluate.VirtualReplay``), held
to tests/test_eviction_policies.py's claims at its sizes and seeds:
per-policy mechanics, the shared-memory-budget mode, invariants over seeded
random access/write/prefetch/drop sequences, replay determinism, and the
thrash crossover the prefetch-aware policy exists for.  Every recording
runs with the trace cache off.  Nothing is left out.

The policy matrix honors ``CAPRE_TEST_POLICIES`` (comma-separated), as the
JAX suite does; default is every registered policy.
"""

import csv
import io
import os
import random

import pytest

from repro_torch.pos.eviction import (
    DEFAULT_POLICY,
    POLICIES,
    ClockPolicy,
    LFUPolicy,
    LRUPolicy,
    PrefetchAwarePolicy,
    make_policy,
)
from repro_torch.pos.latency import ZERO
from repro_torch.pos.store import ObjectStore
from repro_torch.predict.evaluate import (
    VirtualReplay,
    _catalog,
    evaluate_workload,
    record_workload,
    write_csv,
)

ALL_POLICIES = tuple(POLICIES)
TEST_POLICIES = tuple(
    p for p in os.environ.get("CAPRE_TEST_POLICIES", ",".join(ALL_POLICIES)).split(",") if p
)


# ---------------------------------------------------------------------------
# policy mechanics (pure, no store)
# ---------------------------------------------------------------------------


def test_registry_knows_every_policy_and_rejects_unknown():
    assert set(POLICIES) == {"lru", "fifo", "clock", "lfu", "prefetch-aware"}
    assert DEFAULT_POLICY == "lru"
    for name in POLICIES:
        assert make_policy(name, capacity=4).name == name
    with pytest.raises(KeyError, match="unknown eviction policy"):
        make_policy("mru")


def test_lru_bumps_on_access():
    p = LRUPolicy(capacity=3)
    for oid in (1, 2, 3):
        p.note_insert(oid)
    p.note_access(1)
    assert p.pick_victim() == 2  # 1 was bumped past it
    assert p.tracked() == {1, 3}


def test_fifo_ignores_accesses():
    p = make_policy("fifo", capacity=3)
    for oid in (1, 2, 3):
        p.note_insert(oid)
    p.note_access(1)
    p.note_access(1)
    assert p.pick_victim() == 1  # insertion order, recency irrelevant


def test_clock_gives_referenced_lines_a_second_chance():
    p = ClockPolicy(capacity=3)
    for oid in (1, 2, 3):
        p.note_insert(oid)
    p.note_access(1)
    assert p.pick_victim() == 2  # 1 spared once (bit cleared), hand moves on
    assert p.pick_victim() == 3
    assert p.pick_victim() == 1  # bit was cleared: evicted on the next sweep


def test_lfu_evicts_coldest_with_lru_tiebreak():
    p = LFUPolicy(capacity=4)
    for oid in (1, 2, 3):
        p.note_insert(oid)  # freq 1 each
    p.note_access(1)  # freq 2
    assert p.pick_victim() == 2  # freq 1, inserted before 3
    p.note_insert(4)  # freq 1
    assert p.pick_victim() == 3  # freq-1 tie {3, 4}: 3 is least recent
    assert p.pick_victim() == 4
    assert p.pick_victim() == 1  # the hottest line goes last
    assert p.tracked() == set()


def test_prefetch_aware_protects_flood_head_and_releases_on_use():
    p = PrefetchAwarePolicy(capacity=4, window=2)
    for oid in (1, 2, 3, 4):
        p.note_insert(oid, prefetch=True)
    # pending {1,2,3,4}, window 2 -> beyond-window victims newest-first
    assert p.pick_victim() == 4
    assert p.protected_evictions == 1
    p.note_access(1)  # the app used 1: protection ends, 1 joins recency
    p.note_insert(5)  # demand line
    # victims: pending beyond window? pending {2,3} == window -> recency LRU
    assert p.pick_victim() == 1
    assert p.protected_evictions == 2  # 2,3 were spared
    assert p.pick_victim() == 5
    # forced: only protected pending lines remain -> oldest goes
    assert p.pick_victim() == 2
    assert p.protected_evictions == 3  # the forced eviction spared nothing


def test_prefetch_touch_does_not_count_as_use():
    p = PrefetchAwarePolicy(capacity=2, window=1)
    p.note_insert(1, prefetch=True)
    p.note_insert(2)
    p.note_access(1, prefetch=True)  # a second prefetch of 1: still pending
    assert p.pick_victim() == 2  # the demand line goes; 1 stays protected
    p.note_access(1)  # a real use
    p.note_insert(3, prefetch=True)
    assert p.pick_victim() == 1  # now just a recency line


def test_default_window_is_half_capacity():
    assert PrefetchAwarePolicy(capacity=8).window == 4
    assert PrefetchAwarePolicy(capacity=1).window == 1
    assert PrefetchAwarePolicy(capacity=8, window=7).window == 7


# ---------------------------------------------------------------------------
# store-level behavior per policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", TEST_POLICIES)
def test_store_respects_capacity_under_policy(policy):
    store = ObjectStore(n_services=2, cache_capacity=3, cache_policy=policy)
    oids = [store.put("X", {}) for _ in range(12)]
    for o in oids:
        store.app_access(None, o)
    for ds in store.services:
        assert len(ds.cache) <= 3
        assert ds.policy.tracked() == set(ds.cache)
    assert sum(ds.evictions for ds in store.services) == 12 - 6


@pytest.mark.parametrize("policy", TEST_POLICIES)
def test_shared_budget_enforces_global_capacity(policy):
    store = ObjectStore(n_services=4, cache_capacity=5, cache_policy=policy,
                        shared_budget=True)
    oids = [store.put("X", {}) for _ in range(20)]
    for o in oids:
        store.app_access(None, o)
    total = sum(len(ds.cache) for ds in store.services)
    assert total == 5  # one global budget, not 5 per service
    assert set(store.budget.owner) == {o for ds in store.services for o in ds.cache}
    assert store.budget.policy.tracked() == set(store.budget.owner)
    # stealing happened: at least one service lost a line it loaded
    assert sum(ds.evictions for ds in store.services) == 15


def test_shared_budget_steals_dirty_lines_and_flushes_on_victim_service():
    store = ObjectStore(n_services=2, cache_capacity=2, shared_budget=True)
    a = store.put("X", {}, ds=1)
    b = store.put("X", {}, ds=0)
    c = store.put("X", {}, ds=0)
    store.app_write(a)  # dirty on ds1, globally oldest
    store.services[0].load_into_memory(b)
    store.services[0].load_into_memory(c)  # overflow -> steals dirty a from ds1
    ds0, ds1 = store.services
    assert a not in ds1.cache and a not in ds1.dirty
    assert ds1.evictions == 1 and ds1.dirty_evictions == 1 and ds1.flushed_writes == 1
    assert ds0.evictions == 0
    assert store.metrics.dirty_evictions == 1 and store.metrics.flushed_writes == 1


def test_store_protected_evictions_surface_for_prefetch_aware():
    store = ObjectStore(n_services=1, cache_capacity=4, cache_policy="prefetch-aware")
    ds = store.services[0]
    pf = [store.put("X", {}) for _ in range(6)]
    for o in pf:
        store.prefetch_access(o)  # flood: 2 beyond-window bypass evictions
    assert store.protected_evictions() > 0
    store.reset_runtime_state()
    assert store.protected_evictions() == 0
    assert len(ds.cache) == 0 and len(ds.policy.tracked()) == 0


# ---------------------------------------------------------------------------
# property-based invariants over random op sequences
# ---------------------------------------------------------------------------

N_OBJECTS = 24
OP_KINDS = ("access", "write", "prefetch", "drop")


def _apply_ops(store, oids, ops):
    """Drive one op sequence; returns the number of dirty lines flushed by
    explicit ``drop_cache`` calls (the non-eviction flush path)."""
    explicit_flushes = 0
    for kind, idx in ops:
        if kind == "access":
            store.app_access(None, oids[idx % len(oids)])
        elif kind == "write":
            store.app_write(oids[idx % len(oids)])
        elif kind == "prefetch":
            store.prefetch_access(oids[idx % len(oids)])
        else:  # drop one service's cache
            ds = store.services[idx % len(store.services)]
            explicit_flushes += len(ds.dirty)
            ds.drop_cache()
    return explicit_flushes


def _check_invariants(store, capacity, shared, explicit_flushes):
    resident = {}
    for ds in store.services:
        # no oid is resident on a service while the policy thinks it is
        # evicted, and vice versa (residency and ordering metadata agree)
        if ds.budget is None:
            assert ds.policy.tracked() == set(ds.cache)
        # a dirty line is always resident (an evicted dirty line must have
        # been flushed and forgotten)
        assert ds.dirty <= set(ds.cache)
        assert not ds._inflight  # single-threaded: nothing left in flight
        for oid in ds.cache:
            assert oid not in resident  # no oid resident on two services
            resident[oid] = ds.ds_id
    if shared:
        assert sum(len(ds.cache) for ds in store.services) <= capacity
        assert set(store.budget.owner) == set(resident)
        assert store.budget.policy.tracked() == set(resident)
    elif capacity:
        for ds in store.services:
            assert len(ds.cache) <= capacity
    # every write-back was either a dirty eviction or an explicit flush
    assert store.metrics.flushed_writes == store.metrics.dirty_evictions + explicit_flushes
    per_ds_flushes = sum(ds.flushed_writes for ds in store.services)
    per_ds_dirty_ev = sum(ds.dirty_evictions for ds in store.services)
    assert per_ds_flushes == store.metrics.flushed_writes
    assert per_ds_dirty_ev == store.metrics.dirty_evictions


def _state_snapshot(store):
    return (
        store.metrics.snapshot(),
        [(ds.evictions, ds.dirty_evictions, ds.flushed_writes, sorted(ds.cache),
          sorted(ds.dirty)) for ds in store.services],
        sorted(store.accessed_oids),
        sorted(store.prefetched_oids),
        store.protected_evictions(),
    )


def _run_invariant_sequence(policy, capacity, shared, ops):
    store = ObjectStore(n_services=3, latency=ZERO, cache_capacity=capacity,
                        cache_policy=policy, shared_budget=shared)
    oids = [store.put("X", {"v": i}) for i in range(N_OBJECTS)]
    explicit = _apply_ops(store, oids, ops)
    _check_invariants(store, capacity, shared and bool(capacity), explicit)
    first = _state_snapshot(store)
    # replaying the same sequence after a reset reproduces the exact same
    # metrics: reset leaks no policy/budget/dirty state across repetitions
    store.reset_runtime_state()
    explicit = _apply_ops(store, oids, ops)
    _check_invariants(store, capacity, shared and bool(capacity), explicit)
    assert _state_snapshot(store) == first


@pytest.mark.parametrize("policy", TEST_POLICIES)
@pytest.mark.parametrize("shared", (False, True))
def test_invariants_on_seeded_random_sequences(policy, shared):
    """Deterministic pseudo-random sweep (runs even without hypothesis;
    ``test_eviction_properties.py`` deepens the same checker with
    hypothesis-generated sequences)."""
    for seed in range(8):
        rng = random.Random(seed)
        capacity = rng.choice((0, 1, 2, 3, 5, 8))
        ops = [
            (rng.choice(OP_KINDS), rng.randrange(N_OBJECTS))
            for _ in range(rng.randrange(10, 90))
        ]
        _run_invariant_sequence(policy, capacity, shared, ops)


# ---------------------------------------------------------------------------
# replay determinism and the thrash crossover
# ---------------------------------------------------------------------------


def _mask_train_seconds(path):
    """The wall-clock cells in an otherwise virtual-clock CSV (training time
    and the instrumentation's self-metered cost): blank them, return the
    rest of the file byte-for-byte."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    cols = [rows[0].index(c) for c in ("train_seconds", "obs_seconds")]
    for row in rows[1:]:
        for col in cols:
            row[col] = ""
    out = io.StringIO()
    csv.writer(out).writerows(rows)
    return out.getvalue()


def test_replay_csv_rows_are_byte_identical_across_runs(tmp_path):
    """Replaying the same recorded trace twice (same policy sweep) yields
    byte-identical CSV rows — guards the virtual clock against dict-order /
    threading nondeterminism.  ``train_seconds`` is the single wall-clock
    measurement in the file and is masked."""
    wl = _catalog()["bank"]
    recorded = record_workload(wl, runs=2)
    texts = []
    for i in range(2):
        results = evaluate_workload(
            wl, modes=("capre", "markov-miner"), cache_capacities=(0, 32),
            policies=("lru", "prefetch-aware"), recorded=recorded,
        )
        texts.append(_mask_train_seconds(write_csv(results, str(tmp_path / f"run{i}.csv"))))
    assert texts[0] == texts[1]


@pytest.mark.parametrize("app", ("bank", "oo7"))
def test_prefetch_aware_beats_lru_at_small_capacity(app):
    """The acceptance bar: at a small capacity the prefetch-aware policy
    loses strictly fewer prefetches before use and hides no less than LRU
    on the bank/oo7 traces; at unbounded capacity the policies agree."""
    wl = _catalog()[app]
    recorded = record_workload(wl, runs=2)
    small = {
        r.policy: r
        for r in evaluate_workload(wl, modes=("capre",), cache_capacities=(32,),
                                   policies=("lru", "prefetch-aware"), recorded=recorded)
    }
    lru, pa = small["lru"], small["prefetch-aware"]
    assert pa.overhead["evicted_before_use"] < lru.overhead["evicted_before_use"]
    assert pa.timely_coverage >= lru.timely_coverage
    assert pa.overhead["protected_evictions"] > 0
    assert lru.overhead["protected_evictions"] == 0
    unbounded = evaluate_workload(wl, modes=("capre",), cache_capacities=(0,),
                                  policies=("lru", "prefetch-aware"), recorded=recorded)
    a, b = unbounded
    assert (a.timely_coverage, a.stall_seconds, a.evictions) == (
        b.timely_coverage, b.stall_seconds, b.evictions
    )


def test_virtual_replay_shared_budget_matches_live_store_totals():
    """The same flood through both hosts of the shared budget: the replay
    engine and the live store evict the same count under one global
    capacity (one code path, one answer)."""
    n, cap = 2, 4
    live = ObjectStore(n_services=n, cache_capacity=cap, shared_budget=True)
    oids = [live.put("X", {}) for _ in range(10)]
    for o in oids:
        live.app_access(None, o)
    sim_store = ObjectStore(n_services=n)
    sim_oids = [sim_store.put("X", {}) for _ in range(10)]
    engine = VirtualReplay(sim_store, cache_capacity=cap, shared_budget=True)
    for o in sim_oids:
        engine.access(o)
    assert engine.evictions == sum(ds.evictions for ds in live.services) == 10 - cap
    assert sum(len(c) for c in engine.caches) == cap
