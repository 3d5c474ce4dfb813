"""Plain forms of the object store and its recordings, for holding the
port's ``repro_torch.pos`` and POS predictors against the JAX package's.

Objects never cross the packages, so each package builds, populates and
runs its own apps, and the tests compare these forms: trace events as
``TraceEvent.to_tuple()``, a store as the recorded golden's dump
(``[[oid, cls, fields], ...]`` per Data Service), the put log, metric dicts
and the golden's fingerprint.  ``record`` runs each package's own
``predict.evaluate.record_workload`` over its own ``_catalog`` with the
trace cache off, and takes the fingerprint and the dump with that
package's ``_store_fingerprint`` and ``_snapshot_store``.
"""

from __future__ import annotations

import copy
import importlib
import json
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

GOLDEN_DIR = Path(__file__).resolve().parent.parent / "artifacts" / "predict" / "traces"
# the workloads with a committed golden, and the whole catalog
GOLDEN = ("bank", "kmeans", "wordcount")
CATALOG = ("bank", "bank_write", "wordcount", "kmeans", "oo7", "pga")


def _evaluate(pkg: str):
    """The package's ``predict.evaluate`` module."""
    return importlib.import_module(f"{pkg}.predict.evaluate")


def catalog(pkg: str) -> dict:
    """key -> ``Workload``: the package's own ``_catalog()``."""
    return _evaluate(pkg)._catalog()


def _package_of(store) -> str:
    return type(store).__module__.split(".")[0]


def fingerprint(store, root: int, reg) -> dict:
    """The golden's fingerprint, by the store's own package."""
    return _evaluate(_package_of(store))._store_fingerprint(store, root, reg)


def store_dump(store) -> list:
    """Every Data Service's disk as the golden holds it (the store's own
    package's ``_snapshot_store``), through JSON (so tuples and lists
    compare alike)."""
    return json.loads(json.dumps(_evaluate(_package_of(store))._snapshot_store(store)))


def put_log(store) -> list:
    return json.loads(json.dumps([list(entry) for entry in store._put_log]))


def events(trace) -> list:
    """A run's events in the golden's wire form."""
    return [list(ev.to_tuple()) for ev in trace]


def record(pkg: str, key: str, runs: int = 2, n_services: int = 4):
    """The package's ``record_workload`` of the catalog workload ``key``
    (zero latency, prefetch off, ``runs`` cold-cache runs, no trace cache).
    Returns the client, the root, the fingerprint of the freshly populated
    store, each run's events (as ``TraceEvent`` records) and
    ``snapshot_metrics`` after each run."""
    wl = catalog(pkg)[key]
    fresh, metrics = {}, []

    def populate(store):
        # the store as populated, before any run mutates it
        root = wl.populate(store)
        fresh["root"] = root
        fresh["services"] = [SimpleNamespace(ds_id=ds.ds_id, disk=copy.deepcopy(ds.disk))
                             for ds in store.services]
        return root

    def run_once(session, root):
        wl.run_once(session, root)
        metrics.append(session.store.snapshot_metrics())

    client, root, traces = _evaluate(pkg).record_workload(
        replace(wl, populate=populate, run_once=run_once), runs=runs,
        n_services=n_services, cache_dir=None)
    reg = client.logic_module.registered[wl.name]
    fp = _evaluate(pkg)._store_fingerprint(SimpleNamespace(services=fresh["services"]),
                                          fresh["root"], reg)
    return client, root, fp, [t.events for t in traces], metrics


def golden(key: str) -> dict:
    return json.loads((GOLDEN_DIR / f"{key}_r2_ds4_v2.2.json").read_text())


def replay_offline(pkg: str, mode: str, client, app_name: str, train, evaluate,
                   **config) -> list:
    """Warm a POS predictor (its ``SessionConfig`` built from ``config``, the
    defaults otherwise) on the train run's demand oids, attach it to the
    recorded store offline (no session) and drive every event of the
    evaluation run through its hooks, ``on_miss`` on each oid's first
    demand access (the cold cache the trace was recorded on).  Returns, per
    event and hook, what the hook returned, ``take_emission_meta()`` and
    the predictions count."""
    predict = importlib.import_module(f"{pkg}.predict")
    trace_mod = importlib.import_module(f"{pkg}.pos.trace")
    client_mod = importlib.import_module(f"{pkg}.pos.client")
    store = client.store
    predictor = predict.make_pos_predictor(mode, config=client_mod.SessionConfig(**config))
    predictor.warm(trace_mod.trace_oids(train))
    predictor.attach(store, client.logic_module.registered[app_name])
    seen: set = set()
    out = []

    def note(hook, got):
        rfo, priorities = predictor.take_emission_meta()
        out.append((hook, list(got), sorted(rfo), sorted(priorities.items()),
                    predictor.overhead.predictions))

    for ev in evaluate:
        if ev.kind == trace_mod.METHOD_ENTRY:
            note("entry", predictor.on_method_entry(ev.method_key, ev.oid))
            continue
        cls = store.cls_of(ev.oid)
        if ev.oid not in seen:
            seen.add(ev.oid)
            note("miss", predictor.on_miss(ev.oid))
        if ev.kind == trace_mod.WRITE:
            note("write", predictor.on_write(ev.oid, cls))
        else:
            note("access", predictor.on_access(ev.oid, cls))
    return out
