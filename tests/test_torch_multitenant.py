"""The port's multi-tenant harness, held to tests/test_multitenant.py's
claims at its sizes: per-call span attribution (two labeled sessions must
not clobber each other's tracer identity), session lifecycle hygiene (50
open/close cycles leave the obs registry and store listeners at baseline,
with process-unique labels), and the virtual-clock load simulator
(``repro_torch.predict.loadsim``: deterministic rows, admission shedding,
interference attribution).

Left out: the weight streamer's timeout-fallback and zero-worker tests
(tests/test_multitenant.py:175-215), whose twins are in
tests/test_torch_stream.py.
"""

from __future__ import annotations

import threading

import pytest

from repro_torch.obs import Observability
from repro_torch.pos.client import POSClient, Session, SessionConfig
from repro_torch.predict.evaluate import _catalog
from repro_torch.predict.loadsim import (
    LOADGEN_COLUMNS,
    heavy_tailed_weights,
    parse_arrival,
    run_loadsim,
)


def _bank_client(tracing: bool = True):
    wl = _catalog()["bank"]
    client = POSClient(n_services=2)
    obs = Observability(tracing=tracing)
    client.store.attach_obs(obs)
    client.register(wl.build_app())
    root = wl.populate(client.store)
    return client, obs, wl, root


# ---------------------------------------------------------------------------
# bugfix 1: span attribution is per-call, not shared tracer state
# ---------------------------------------------------------------------------


def test_two_labeled_sessions_attribute_spans_to_their_own_label():
    """Creating session B after session A must not relabel A's spans.

    The old code did ``store.obs.tracer.session = label`` in
    ``Session.__init__`` — whichever session was constructed *last* owned
    every span on the shared store, so two concurrent tenants were
    indistinguishable in the timeline."""
    client, obs, wl, root = _bank_client()
    reg = client.logic_module.registered[wl.name]
    sa = Session(client.store, reg,
                 SessionConfig(mode="capre", session_label="tA"))
    sb = Session(client.store, reg,
                 SessionConfig(mode="capre", session_label="tB"))
    try:
        # B was constructed last; under the clobbered-tracer behavior A's
        # spans now carry "tB"
        wl.run_once(sa, root)
        sa.drain(10.0)
        labels = {s.session for s in obs.tracer.spans() if s.session}
        assert "tA" in labels
        assert "tB" not in labels  # B never ran anything
        wl.run_once(sb, root)
        sb.drain(10.0)
        labels = {s.session for s in obs.tracer.spans() if s.session}
        assert {"tA", "tB"} <= labels
    finally:
        sa.close()
        sb.close()


def test_concurrent_labeled_sessions_interleave_attribution():
    client, obs, wl, root = _bank_client()
    reg = client.logic_module.registered[wl.name]

    def drive(label: str) -> None:
        s = Session(client.store, reg,
                    SessionConfig(mode="capre", session_label=label))
        try:
            wl.run_once(s, root)
            s.drain(10.0)
        finally:
            s.close()

    threads = [threading.Thread(target=drive, args=(lbl,))
               for lbl in ("tX", "tY")]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    labels = {s.session for s in obs.tracer.spans() if s.session}
    assert {"tX", "tY"} <= labels


def test_demand_stalls_land_in_the_tenant_histogram():
    client, obs, wl, root = _bank_client(tracing=False)
    reg = client.logic_module.registered[wl.name]
    with Session(client.store, reg,
                 SessionConfig(session_label="tH")) as s:
        wl.run_once(s, root)
    hist = obs.registry.histogram("tenant_stall_s", tenant="tH")
    assert hist.count > 0  # every demand event recorded a (possibly 0) stall


# ---------------------------------------------------------------------------
# bugfix 2: session lifecycle leaves no registry/listener residue
# ---------------------------------------------------------------------------


def test_open_close_churn_restores_registry_and_listeners():
    client, obs, wl, root = _bank_client(tracing=False)
    reg = client.logic_module.registered[wl.name]
    baseline_sources = set(obs.registry.source_names())
    baseline_listeners = (client.store.miss_listener,
                          client.store.access_listener)
    labels = []
    for _ in range(50):
        s = Session(client.store, reg, SessionConfig(mode="capre"))
        labels.append(s.label)
        s.close()
    # the old register_source had no inverse: 50 runtime/<label> sources
    # (minus the id()-collision overwrites) accumulated forever
    assert set(obs.registry.source_names()) == baseline_sources
    assert not any(n.startswith("runtime/")
                   for n in obs.registry.source_names())
    assert (client.store.miss_listener,
            client.store.access_listener) == baseline_listeners
    # the old default label, id(self) & 0xFFFF, collides under churn
    # (CPython reuses freed addresses); the counter scheme never does
    assert len(set(labels)) == 50


def test_unregister_source_reports_membership():
    from repro_torch.obs import Registry

    r = Registry()
    r.register_source("x", lambda: {})
    assert r.unregister_source("x") is True
    assert r.unregister_source("x") is False
    assert "x" not in r.source_names()


# ---------------------------------------------------------------------------
# the virtual-clock load simulator
# ---------------------------------------------------------------------------


def test_loadsim_rows_are_deterministic_across_runs():
    kw = dict(tenants=6, arrival="poisson:400", jobs=2, seed=11,
              mix=("bank", "wordcount"), cache_capacity=64,
              shared_budget=True, max_outstanding=4,
              admission_threshold=0.5)
    a = run_loadsim(**kw)
    b = run_loadsim(**kw)
    assert a.rows() == b.rows()


def test_loadsim_row_schema_and_aggregate():
    rep = run_loadsim(tenants=4, arrival="closed", jobs=1, seed=3,
                      mix=("bank", "wordcount"), cache_capacity=64,
                      shared_budget=True)
    rows = rep.rows()
    assert len(rows) == 5  # 4 tenants + ALL
    for row in rows:
        assert set(row) == set(LOADGEN_COLUMNS)
        assert row["clock"] == "virtual"
        assert row["wall_s"] == ""  # byte-reproducible: no wall cells
    agg = rows[-1]
    assert agg["tenant"] == "ALL"
    assert agg["ops"] == sum(r["ops"] for r in rows[:-1])
    assert agg["fairness_ratio"] == round(rep.fairness_ratio, 4)
    per_tenant_ops = [r["ops"] for r in rows[:-1]]
    assert all(ops > 0 for ops in per_tenant_ops)


def test_loadsim_admission_mirror_sheds_under_pressure():
    kw = dict(tenants=8, arrival="poisson:5000", jobs=2, seed=5,
              mix=("bank", "kmeans"), cache_capacity=64,
              shared_budget=True)
    open_gate = run_loadsim(**kw, max_outstanding=0)
    throttled = run_loadsim(**kw, max_outstanding=2,
                            admission_threshold=2.0)  # nothing bypasses
    assert sum(t.admission_shed for t in open_gate.per_tenant) == 0
    assert sum(t.admission_shed for t in throttled.per_tenant) > 0


def test_loadsim_attributes_interference_to_tenants():
    rep = run_loadsim(tenants=8, arrival="closed", jobs=1, seed=7,
                      mix=("bank", "wordcount"), cache_capacity=32,
                      shared_budget=True)
    # a 32-line shared budget under 8 tenants must destroy someone's
    # unused prefetches, and the owner map must name the victims
    assert sum(t.evicted_before_use for t in rep.per_tenant) > 0
    assert sum(t.evicted_before_use for t in rep.per_tenant) <= rep.evictions


def test_parse_arrival_and_mix_weights():
    assert parse_arrival("closed") == ("closed", 0.0)
    assert parse_arrival("poisson:250") == ("poisson", 250.0)
    with pytest.raises(ValueError):
        parse_arrival("poisson:0")
    with pytest.raises(ValueError):
        parse_arrival("uniform:10")
    w = heavy_tailed_weights(4)
    assert w == sorted(w, reverse=True) and w[0] == 1.0
