"""The port's Chrome-trace export (``repro_torch.obs.export``) against the
JAX package's, on the CPU.

Each package records the bank app with the trace cache off, warms a
predictor on the first run and replays the second on the virtual clock
with a ``Tracer`` (as tests/test_obs.py's virtual bank replay does), then
exports the spans with its own ``chrome_trace``.  Virtual timestamps are
deterministic, so ``json.dumps(..., sort_keys=True)`` of the two traces
must be the same text, and so must the files ``write_chrome_trace``
writes; the port's trace must also pass both validators with every loaded
prefetch span drawn in at least four phases.  The validators and the
phase counter must return the same answers as JAX's on malformed inputs,
and a wall-clock trace of hand-fed spans must export alike too.
"""

import json

import pytest

from torch_replay_canon import PACKAGES, first_difference, module


def _virtual_trace(pkg: str, mode: str, dispatch: str, capacity: int, scenario: str):
    """The package's tracer spans and instants of the virtual bank replay."""
    ev = module(pkg, "predict.evaluate")
    obs = module(pkg, "obs")
    client_mod = module(pkg, "pos.client")
    wl = ev._catalog()["bank"]
    client, _root, traces = ev.record_workload(wl, runs=2)
    sc = None
    if scenario != "no-fault":
        client.store.rebuild_placement("round-robin", replication=2)
        clean = ev.replay_baseline(traces[-1], client.store)
        sc = module(pkg, "pos.latency").make_scenario(
            scenario, end_t=clean.t - clean.stall_seconds)
    reg = client.logic_module.registered[wl.name]
    predictor = module(pkg, "predict").make_pos_predictor(
        mode, config=client_mod.SessionConfig(rop_depth=2))
    predictor.warm(traces[0].accesses)
    tracer = obs.Tracer()
    ev.replay(traces[-1], predictor, client.store, reg, dispatch=dispatch,
              cache_capacity=capacity, tracer=tracer, scenario=sc)
    return tracer.spans(), tracer.instants()


CASES = {
    "capre-batch": ("static-capre", "batch", 0, "no-fault"),
    "capre-per-oid": ("static-capre", "per-oid", 0, "no-fault"),
    "hybrid-bounded": ("hybrid", "batch", 32, "no-fault"),
    "rop-crash": ("rop", "batch", 0, "crash"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_virtual_bank_trace_equals_jax(case, tmp_path):
    texts, files = {}, {}
    for pkg in PACKAGES:
        export = module(pkg, "obs.export")
        spans, instants = _virtual_trace(pkg, *CASES[case])
        obj = export.chrome_trace(spans, clock="virtual", instants=instants)
        texts[pkg] = json.dumps(obj, sort_keys=True)
        path = tmp_path / f"{pkg}.trace.json"
        export.write_chrome_trace(str(path), spans, clock="virtual", instants=instants)
        files[pkg] = path.read_bytes()
        if pkg == "repro_torch":
            back = json.loads(files[pkg])
            assert export.validate_chrome_trace(back) == []
            assert export.validate_flow_pairing(back) == []
            phases = export.full_lifecycle_phase_counts(back)
            loaded = [s for s in spans if s.kind == "prefetch" and s.load_done_t is not None]
            assert loaded and all(phases.get(s.oid, 0) >= 4 for s in loaded)
            assert any(e["ph"] == "C" for e in back["traceEvents"])
            if CASES[case][3] != "no-fault":
                assert any(e.get("cat") == "fault" for e in back["traceEvents"])
    diff = first_difference(texts["repro_torch"], texts["repro"])
    assert diff is None, diff
    diff = first_difference(files["repro_torch"], files["repro"])
    assert diff is None, diff


MALFORMED = {
    "not-a-dict": [],
    "wrong-key": {"events": []},
    "events-not-a-list": {"traceEvents": {}},
    "negative-ts-and-dur": {"traceEvents": [{"name": "x", "ph": "X", "ts": -1.0, "pid": 0,
                                             "tid": 0, "dur": -2.0}]},
    "missing-keys": {"traceEvents": [{"ph": "i"}, 3]},
    "unserializable": {"traceEvents": [{"name": "x", "ph": "i", "ts": 0.0, "pid": 0,
                                        "tid": 0, "args": {1, 2}}]},
    "flow-without-id": {"traceEvents": [{"name": "f", "ph": "s", "ts": 1.0, "pid": 0,
                                         "tid": 0}]},
    "flows-mispaired": {"traceEvents": [
        {"name": "a", "ph": "s", "id": 1, "ts": 5.0, "pid": 0, "tid": 0},
        {"name": "a", "ph": "t", "id": 1, "ts": 2.0, "pid": 0, "tid": 0},
        {"name": "a", "ph": "f", "id": 1, "ts": 6.0, "pid": 0, "tid": 0},
        {"name": "a", "ph": "f", "id": 1, "ts": 7.0, "pid": 0, "tid": 0},
        {"name": "b", "ph": "f", "id": 2, "ts": 1.0, "pid": 0, "tid": 0},
        {"name": "c", "ph": "s", "id": 3, "ts": 1.0, "pid": 0, "tid": 0},
        {"name": "c", "ph": "s", "id": 3, "ts": 2.0, "pid": 0, "tid": 0},
    ]},
    "many-problems": {"traceEvents": [{"ph": "X", "ts": -1.0} for _ in range(30)]},
    "phases": {"traceEvents": [
        {"name": "p", "cat": "prefetch,predicted", "ph": "X", "ts": 0.0, "dur": 1.0,
         "pid": 0, "tid": 0, "args": {"oid": 4}},
        {"name": "p", "cat": "prefetch,disk", "ph": "X", "ts": 1.0, "dur": 1.0,
         "pid": 0, "tid": 0, "args": {"oid": 4}},
        {"name": "d", "cat": "demand,disk", "ph": "X", "ts": 1.0, "dur": 1.0,
         "pid": 0, "tid": 0, "args": {"oid": 5}},
    ]},
}


def _answer(fn, obj):
    """What ``fn(obj)`` returns, or the name of what it raises."""
    try:
        return fn(obj)
    except Exception as exc:  # noqa: BLE001 - the raise is the answer compared
        return ("raises", type(exc).__name__)


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_validators_equal_jax_on_malformed_input(case):
    obj = MALFORMED[case]
    got, want = ({name: _answer(getattr(module(pkg, "obs.export"), name), obj)
                  for name in ("validate_chrome_trace", "validate_flow_pairing",
                               "full_lifecycle_phase_counts")}
                 for pkg in PACKAGES)
    assert got == want
    if case != "phases":
        assert got["validate_chrome_trace"] or got["validate_flow_pairing"]


def _hand_fed(pkg: str):
    """A wall-clock tracer fed fixed timestamps: a hit, a partial, a
    suppressed and an evicted prefetch, a demand miss and a crash marker."""
    tr = module(pkg, "obs").Tracer(session="s")
    tr.predicted([1, 2, 3], origin="capre:m", t=100.0)
    bid = tr.new_batch()
    tr.dispatched([1, 2, 3], service=1, batch_id=bid, t=100.5)
    tr.claimed([1, 2], service=1, t=101.0)
    tr.suppressed([3], service=1, t=101.0)
    tr.loaded([1], service=1, lane=0, queued_t=101.0, start_t=101.5, done_t=102.0)
    tr.loaded([2], service=1, lane=1, queued_t=101.0, start_t=102.0, done_t=104.0)
    tr.demand(1, service=1, needed_t=103.0, stall_s=0.0, full_load=False,
              disk_load_s=0.5, t=103.0)
    tr.demand(2, service=1, needed_t=103.5, stall_s=0.5, full_load=False,
              disk_load_s=2.0, t=104.0)
    tr.predicted([4], t=104.0)
    tr.dispatched([4], 2, tr.new_batch(), t=104.0)
    tr.claimed([4], 2, t=104.0)
    tr.loaded([4], 2, 0, 104.0, 104.0, 104.5)
    tr.evicted(4, t=105.0)
    tr.demand(9, service=0, needed_t=105.0, stall_s=1.0, full_load=True,
              disk_load_s=1.0, t=106.0)
    tr.instant("service-crash", service=2, t=105.5)
    return tr


def test_wall_clock_trace_equals_jax():
    texts = {}
    for pkg in PACKAGES:
        tr = _hand_fed(pkg)
        obj = module(pkg, "obs.export").chrome_trace(
            tr.spans(), clock="wall", instants=tr.instants(),
            process_names={0: "demand host"})
        texts[pkg] = json.dumps(obj, sort_keys=True)
    diff = first_difference(texts["repro_torch"], texts["repro"])
    assert diff is None, diff
    obj = json.loads(texts["repro_torch"])
    assert obj["otherData"] == {"clock": "wall", "spans": 5}
    assert min(e["ts"] for e in obj["traceEvents"] if e["ph"] != "M") == 0.0
