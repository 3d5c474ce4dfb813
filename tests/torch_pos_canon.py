"""Plain forms of the object store and its recordings, for holding the
port's ``repro_torch.pos`` and POS predictors against the JAX package's.

Objects never cross the packages, so each package builds, populates and
runs its own apps, and the tests compare these forms: trace events as
``TraceEvent.to_tuple()``, a store as the recorded golden's dump
(``[[oid, cls, fields], ...]`` per Data Service), the put log, metric dicts
and the golden's fingerprint.  ``record`` is the recipe of the JAX
package's ``predict.evaluate.record_workload`` (zero latency, prefetch off,
cold-cache runs) over the catalog sizes of its ``_catalog``, written
against either package by name.
"""

from __future__ import annotations

import hashlib
import importlib
import json
from pathlib import Path

GOLDEN_DIR = Path(__file__).resolve().parent.parent / "artifacts" / "predict" / "traces"
# the workloads with a committed golden, and the whole catalog
GOLDEN = ("bank", "kmeans", "wordcount")
CATALOG = ("bank", "bank_write", "wordcount", "kmeans", "oo7", "pga")


def catalog(pkg: str) -> dict:
    """key -> (registered app name, app builder, populate(store) -> root,
    run_once(session, root)), at ``predict.evaluate._catalog``'s sizes."""
    apps = {m: importlib.import_module(f"{pkg}.apps.{m}")
            for m in ("bank", "kmeans", "oo7", "pga", "wordcount")}
    bank, kmeans = apps["bank"], apps["kmeans"]
    cents = [list(c) for c in kmeans.initial_centroids(k=3, dims=6)]
    return {
        "bank": ("bank", bank.build_bank_app,
                 lambda store: bank.populate_bank_store(store, n_transactions=60),
                 lambda s, root: s.execute(root, "auditAll")),
        "bank_write": ("bank", bank.build_bank_app,
                       lambda store: bank.populate_bank_store(store, n_transactions=60),
                       lambda s, root: s.execute(root, "setAllTransCustomers")),
        "wordcount": ("wordcount", apps["wordcount"].build_wordcount_app,
                      lambda store: apps["wordcount"].populate_wordcount(
                          store, chunks_per_text=8, words_per_chunk=6),
                      lambda s, root: s.execute(root, "run")),
        "kmeans": ("kmeans", kmeans.build_kmeans_app,
                   lambda store: kmeans.populate_kmeans(store, n_vectors=240,
                                                        n_collections=3, dims=6),
                   lambda s, root: s.execute(root, "run", cents)),
        "oo7": ("oo7", apps["oo7"].build_oo7_app,
                lambda store: apps["oo7"].populate_oo7(store, size="small"),
                lambda s, root: s.execute(root, "t1")),
        "pga": ("pga", apps["pga"].build_pga_app,
                lambda store: apps["pga"].populate_pga(store, n_vertices=120,
                                                       out_degree=3)[0],
                lambda s, root: s.execute(root, "dfs")),
    }


def fingerprint(store, root: int, reg) -> dict:
    """The golden's fingerprint: counts and a SHA-1 over every object and
    over the registration's hints."""
    h = hashlib.sha1()
    n_objects = 0
    for ds in store.services:
        for oid in sorted(ds.disk):
            rec = ds.disk[oid]
            n_objects += 1
            h.update(repr((ds.ds_id, oid, rec.cls, sorted(rec.fields.items()))).encode())
    h.update(repr(sorted((key, tuple(hint.steps for hint in hints))
                         for key, hints in reg.report.hints.items())).encode())
    return {"root": root, "n_objects": n_objects, "n_services": len(store.services),
            "content_sha1": h.hexdigest()}


def store_dump(store) -> list:
    """Every Data Service's disk as the golden holds it, through JSON (so
    tuples and lists compare alike)."""
    return json.loads(json.dumps([
        [[rec.oid, rec.cls, rec.fields] for _oid, rec in sorted(ds.disk.items())]
        for ds in store.services]))


def put_log(store) -> list:
    return json.loads(json.dumps([list(entry) for entry in store._put_log]))


def events(trace) -> list:
    """A run's events in the golden's wire form."""
    return [list(ev.to_tuple()) for ev in trace]


def record(pkg: str, key: str, runs: int = 2, n_services: int = 4):
    """Populate a zero-latency store and record ``runs`` cold-cache runs of
    the workload with prefetching off.  Returns the client, the root, the
    fingerprint of the freshly populated store, each run's events (as
    ``TraceEvent`` records) and ``snapshot_metrics`` after each run."""
    client_mod = importlib.import_module(f"{pkg}.pos.client")
    name, build_app, populate, run_once = catalog(pkg)[key]
    client = client_mod.POSClient(n_services=n_services)
    reg = client.register(build_app())
    root = populate(client.store)
    fp = fingerprint(client.store, root, reg)
    traces, metrics = [], []
    for _ in range(runs):
        client.store.reset_runtime_state()
        client.store.trace = []
        session = client_mod.Session(client.store, client.logic_module.registered[name])
        try:
            run_once(session, root)
        finally:
            session.close()
        traces.append(list(client.store.trace))
        metrics.append(client.store.snapshot_metrics())
        client.store.trace = None
    return client, root, fp, traces, metrics


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
