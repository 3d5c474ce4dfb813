"""The port's eviction subsystem and store fault detector against the JAX
package's, on the CPU.

A hypothesis differential over every policy of ``pos.eviction``, per
service and under a ``SharedBudget``: one random sequence of application
accesses, writes, prefetches and cache drops drives a JAX store and a port
store alike, and after each operation their metrics, each service's cache
membership, dirty lines and counters, and the lines the operation evicted
must be equal.  Then ``runtime.fault.StoreFaultDetector`` attached to
both stores under one injected clock, fed the same landed loads (a
straggling service among them) and ticks, must flag the same services
down and the same stragglers at every step.  No thread runs (zero latency,
no session), so every comparison is exact.
"""

import random

import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st

from repro.pos.eviction import POLICIES as JPOLICIES
from repro.pos.latency import LatencyModel as JLatencyModel
from repro.pos.latency import ZERO as JZERO
from repro.pos.store import ObjectStore as JObjectStore
from repro_torch.pos.eviction import POLICIES
from repro_torch.pos.latency import ZERO, LatencyModel
from repro_torch.pos.store import ObjectStore

N_OBJECTS = 24
OP_KINDS = ("access", "write", "prefetch", "drop")


def _apply(store, oids, kind, idx) -> None:
    if kind == "access":
        store.app_access(None, oids[idx % len(oids)])
    elif kind == "write":
        store.app_write(oids[idx % len(oids)])
    elif kind == "prefetch":
        store.prefetch_access(oids[idx % len(oids)])
    else:
        store.services[idx % len(store.services)].drop_cache()


def _state(store) -> tuple:
    return (
        store.snapshot_metrics(),
        [(sorted(ds.cache), sorted(ds.dirty), ds.evictions, ds.dirty_evictions,
          ds.flushed_writes) for ds in store.services],
        sorted(store.accessed_oids),
        sorted(store.prefetched_oids),
        store.protected_evictions(),
    )


def _resident(store) -> set:
    return {(ds.ds_id, oid) for ds in store.services for oid in ds.cache}


def test_policies_equal_jax():
    assert tuple(POLICIES) == tuple(JPOLICIES)


@pytest.mark.parametrize("policy", tuple(POLICIES))
@settings(max_examples=25, deadline=None)
@given(
    capacity=st.sampled_from((0, 1, 2, 3, 5, 8)),
    shared=st.booleans(),
    ops=st.lists(st.tuples(st.sampled_from(OP_KINDS), st.integers(0, N_OBJECTS - 1)),
                 max_size=120),
)
def test_store_under_every_policy_equals_jax(policy, capacity, shared, ops):
    stores = [cls(n_services=3, latency=lat, cache_capacity=capacity, cache_policy=policy,
                  shared_budget=shared)
              for cls, lat in ((ObjectStore, ZERO), (JObjectStore, JZERO))]
    oids = [[s.put("X", {"v": i}) for i in range(N_OBJECTS)] for s in stores]
    assert oids[0] == oids[1]
    for rep in range(2):  # the second pass after reset_runtime_state
        for kind, idx in ops:
            before = [_resident(s) for s in stores]
            for s, o in zip(stores, oids):
                _apply(s, o, kind, idx)
            after = [_resident(s) for s in stores]
            evicted = [b - a for b, a in zip(before, after)]
            assert evicted[0] == evicted[1], (kind, idx)
            assert _state(stores[0]) == _state(stores[1]), (kind, idx)
        for s in stores:
            s.reset_runtime_state()
        assert _state(stores[0]) == _state(stores[1])


def _fault_store(cls, lat_cls, clock):
    # six services, the third ten times slower on disk; zero sleeps (every
    # duration is below the latency model's sleep floor), a two-line cache
    # so that accesses keep landing loads
    lat = lat_cls(disk_load=1e-6, remote_hop=0.0, write_back=0.0,
                  think=0.0).with_stragglers({2: 10.0})
    store = cls(n_services=6, latency=lat, cache_capacity=2)
    oids = [store.put("X", {"v": i}) for i in range(36)]
    detector = store.attach_fault_detection(heartbeat_timeout=5.0, clock=clock,
                                            check_every=4)
    return store, oids, detector


@pytest.mark.parametrize("seed", range(4))
def test_store_fault_detector_equals_jax(seed):
    """Both stores flag the straggling service, and the service whose
    objects stop being read goes down once the clock passes the timeout,
    at the same step in both; a forced tick and a readmission agree too."""
    now = [0.0]
    clock = lambda: now[0]  # noqa: E731
    ports = _fault_store(ObjectStore, LatencyModel, clock)
    jaxs = _fault_store(JObjectStore, JLatencyModel, clock)
    rng = random.Random(seed)
    silent = 5
    for step in range(400):
        # after step 150 service 5's objects are no longer read
        pool = [i for i, o in enumerate(ports[1])
                if step < 150 or ports[0]._placement[o][0] != silent]
        i = rng.choice(pool)
        now[0] += rng.uniform(0.0, 0.1)
        for store, oids, _det in (ports, jaxs):
            store.app_access(None, oids[i])
        assert ports[0]._down == jaxs[0]._down, step
        assert ports[0]._slow == jaxs[0]._slow, step
        assert ports[2].monitor.failed == jaxs[2].monitor.failed, step
        assert ports[0].snapshot_metrics() == jaxs[0].snapshot_metrics(), step
    for _store, _oids, det in (ports, jaxs):
        det.tick(force=True)
    assert ports[0]._down == jaxs[0]._down == {silent}
    assert ports[0]._slow == jaxs[0]._slow == {2}
    for store, _oids, _det in (ports, jaxs):
        store.revive_service(silent)
        store.revive_service(2)
    assert ports[0]._down == jaxs[0]._down == set()
    assert ports[0]._slow == jaxs[0]._slow == set()
    assert ports[2].monitor.failed == jaxs[2].monitor.failed == set()
    assert ports[2].straggler._durations == jaxs[2].straggler._durations
    assert ports[0].snapshot_metrics() == jaxs[0].snapshot_metrics()
