"""The port's POS predictors (``repro_torch.predict``: static-capre, rop,
markov-miner, hybrid) against the JAX package's, offline, on the CPU.

Each package records each catalog workload itself (zero latency, prefetch
off, two cold-cache runs; ``torch_pos_canon.record``), and each predictor
is warmed on the first run's demand oids and attached to the recorded
store without a session, as the JAX package's offline replay does.  Every
event of the second run then goes through the hooks (``on_method_entry``;
``on_miss`` on each oid's first demand access, the cold cache the trace was
recorded on; ``on_write`` or ``on_access``), and the port's returned oid
lists, ``take_emission_meta()`` (the read-for-ownership oids and dispatch
priorities) and ``overhead.predictions`` must equal JAX's event by event.
Offline, no thread runs, so every comparison is exact.
"""

import pytest

from repro_torch import predict
from torch_pos_canon import CATALOG, catalog, events, record, replay_offline

_RECORDED: dict = {}


def _recorded(pkg: str, key: str):
    if (pkg, key) not in _RECORDED:
        _RECORDED[pkg, key] = record(pkg, key)
    return _RECORDED[pkg, key]


def _replay(pkg: str, mode: str, key: str) -> list:
    client, _root, _fp, traces, _metrics = _recorded(pkg, key)
    return replay_offline(pkg, mode, client, catalog(pkg)[key].name, traces[0], traces[1])


@pytest.mark.parametrize("key", CATALOG)
@pytest.mark.parametrize("mode", predict.available("pos"))
def test_offline_predictions_equal_jax(mode, key):
    assert [events(t) for t in _recorded("repro_torch", key)[3]] == [
        events(t) for t in _recorded("repro", key)[3]]
    got, want = _replay("repro_torch", mode, key), _replay("repro", mode, key)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, (i, a, b)
    # the replay exercised the predictor: it emitted something on every
    # workload but ROP's on kmeans, whose model has no single association
    assert got[-1][-1] > 0 or (mode, key) == ("rop", "kmeans")


@pytest.mark.parametrize("mode", predict.available("pos"))
def test_offline_hooks_schedule_nothing(mode):
    """Offline (no session) the hooks only return lists: the recorded
    store is left as it was, with nothing loaded or traced."""
    client, *_ = record("repro_torch", "bank")
    before = client.store.snapshot_metrics()
    cached = [dict(ds.cache) for ds in client.store.services]
    traces = _recorded("repro_torch", "bank")[3]
    replay_offline("repro_torch", mode, client, "bank", traces[0], traces[1])
    assert client.store.snapshot_metrics() == before
    assert [dict(ds.cache) for ds in client.store.services] == cached
    assert client.store.trace is None and not client.store.prefetched_oids


def test_emission_meta_carries_rfo_on_the_mutating_traversal():
    """On setAllTransCustomers the optimizer marks the updated accounts
    read-for-ownership: static-capre's offline emissions carry the 60
    accounts (one a transaction) and dispatch priorities; ROP's, the
    miner's and the hybrid's (whose static part keeps its own pending
    metadata) carry none."""
    by_mode = {m: _replay("repro_torch", m, "bank_write") for m in predict.available("pos")}
    rfo = {m: {o for row in rows for o in row[2]} for m, rows in by_mode.items()}
    prio = {m: {o for row in rows for o, _p in row[3]} for m, rows in by_mode.items()}
    client = _recorded("repro_torch", "bank_write")[0]
    assert len(rfo["static-capre"]) == 60
    assert {client.store.cls_of(o) for o in rfo["static-capre"]} == {"Account"}
    assert prio["static-capre"]
    for m in ("rop", "markov-miner", "hybrid"):
        assert not rfo[m] and not prio[m], m
