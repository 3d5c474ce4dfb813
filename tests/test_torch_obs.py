"""The port's observability layer (``repro_torch.obs``), held to
tests/test_obs.py's claims at its sizes and seeds: histogram percentiles
against numpy, the registry's lifecycle, span lifecycle invariants on both
clocks (hard-drain and reset paths included), wall-vs-virtual span-field
parity, the Chrome-trace export's schema (``repro_torch.obs.export``), the
stall-percentile replay columns and the calibration loader
(``repro_torch.predict.calibration``).  Every recording runs with the trace
cache off.

Left out:

* the gate test of ``benchmarks/compare_predict.py``
  (tests/test_obs.py:407), which the port does not carry;
* the weight streamer's registry test (tests/test_obs.py:484), whose twin
  is in tests/test_torch_stream.py.

tests/test_obs.py:439 holds the committed ``baseline.csv`` to carry the
percentile columns; its twin holds the port's ``write_csv`` header to that
file's header, column for column.
"""

import json
import math

import numpy as np
import pytest

from repro_torch.obs import (
    Histogram,
    Meter,
    Observability,
    Registry,
    SpanError,
    Tracer,
    check_span_invariants,
    chrome_trace,
    full_lifecycle_phase_counts,
    validate_chrome_trace,
    write_chrome_trace,
)
from repro_torch.obs.metrics import log_buckets
from repro_torch.pos.client import POSClient, SessionConfig
from repro_torch.predict import make_pos_predictor
from repro_torch.predict.base import Overhead
from repro_torch.predict.calibration import (
    Calibration,
    calibrated_model,
    load_calibration,
)
from repro_torch.pos.latency import REPLAY, LatencyModel
from repro_torch.predict.evaluate import (
    CSV_COLUMNS,
    _calibration_app_key,
    _catalog,
    record_workload,
    replay,
)

# ---------------------------------------------------------------------------
# histograms
# ---------------------------------------------------------------------------


def test_exact_histogram_matches_numpy_percentiles():
    rng = np.random.default_rng(42)
    xs = rng.exponential(0.01, size=500)
    h = Histogram(exact=True)
    for x in xs:
        h.record(float(x))
    for q in (0.5, 0.9, 0.99, 0.999):
        assert h.percentile(q) == pytest.approx(
            float(np.percentile(xs, q * 100)), rel=1e-9
        )
    p50, p99, p999 = h.percentiles()
    assert p50 <= p99 <= p999


def test_bucketed_histogram_estimate_within_bucket_resolution():
    rng = np.random.default_rng(7)
    xs = rng.lognormal(mean=-6.0, sigma=1.5, size=500)
    h = Histogram(exact=False)
    for x in xs:
        h.record(float(x))
    width = 10 ** (1 / 8)  # one bucket per 1/8 decade
    for q in (0.5, 0.9, 0.99):
        est = h.percentile(q)
        true = float(np.percentile(xs, q * 100))
        # the estimate is the geometric midpoint of the rank's bucket —
        # within two bucket widths of the exact quantile
        assert true / width**2 <= est <= true * width**2


def test_histogram_under_and_overflow():
    h = Histogram(lo=1e-6, hi=100.0)
    for _ in range(10):
        h.record(0.0)  # fully hidden stalls land in the underflow bucket
    assert h.percentile(0.5) == 0.0
    h.record(1e6)  # beyond hi: overflow bucket, estimated by the max bound
    assert h.percentile(0.999) == pytest.approx(1e6)
    assert h.count == 11
    h.record(-1.0)  # negatives clamp to zero, never throw off the sum
    assert h.min == 0.0 and h.sum == pytest.approx(1e6)


def test_log_buckets_are_log_spaced():
    edges = log_buckets(1e-6, 100.0, per_decade=8)
    assert edges[0] == pytest.approx(1e-6)
    assert edges[-1] == pytest.approx(100.0)
    ratios = [b / a for a, b in zip(edges, edges[1:])]
    assert all(r == pytest.approx(10 ** (1 / 8)) for r in ratios)


def test_histogram_merge_pools_populations():
    a, b = Histogram(exact=True), Histogram(exact=True)
    for x in (0.001, 0.002):
        a.record(x)
    for x in (0.003, 0.004):
        b.record(x)
    a.merge_from(b)
    assert a.count == 4
    assert a.percentile(0.5) == pytest.approx(0.0025)


def test_histogram_self_metering_charges_the_overhead_ledger():
    meter = Meter()
    h = Histogram(exact=True, meter=meter)
    h.record(0.001)
    assert meter.events == 1 and meter.seconds > 0.0
    obs = Observability(tracing=True)
    obs.registry.histogram("x").record(0.5)
    obs.tracer.predicted([1], t=0.0)
    obs.tracer.drop_active(t=1.0)
    ledger = Overhead()
    obs.charge(ledger)
    assert ledger.obs_events >= 2
    assert ledger.obs_seconds > 0.0


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_registry_get_or_create_and_merged_percentiles():
    reg = Registry()
    assert reg.counter("hits", service=0) is reg.counter("hits", service=0)
    assert reg.counter("hits", service=0) is not reg.counter("hits", service=1)
    reg.histogram("stall_s", service=0).record(0.001)
    reg.histogram("stall_s", service=1).record(0.1)
    merged = reg.merged_histogram("stall_s")
    assert merged.count == 2
    assert reg.percentiles("missing") == [None, None, None]
    reg.register_source("store", lambda: {"app_loads": 3})
    snap = reg.snapshot()
    assert snap["sources"]["store"] == {"app_loads": 3}
    assert len(snap["histograms"]["stall_s"]) == 2
    reg.reset()
    assert reg.merged_histogram("stall_s").count == 0
    assert reg.meter.events == 0


# ---------------------------------------------------------------------------
# span lifecycle (unit level)
# ---------------------------------------------------------------------------


def test_tracer_full_lifecycle_and_invariants():
    tr = Tracer(session="t")
    tr.predicted([1, 2], origin="capre:m", t=0.0)
    bid = tr.new_batch()
    tr.dispatched([1, 2], service=0, batch_id=bid, t=1.0)
    tr.claimed([1, 2], service=0, t=2.0)
    tr.loaded([1], service=0, lane=0, queued_t=2.0, start_t=3.0, done_t=5.0)
    tr.loaded([2], service=0, lane=1, queued_t=2.0, start_t=3.0, done_t=5.0)
    tr.demand(1, service=0, needed_t=6.0, stall_s=0.0, full_load=False,
              disk_load_s=2.0, t=6.0)  # resident -> hit
    tr.evicted(2, t=7.0)  # never demanded -> evicted
    spans = tr.spans()
    assert check_span_invariants(spans) == []
    by_oid = {s.oid: s for s in spans}
    assert by_oid[1].outcome == "hit"
    assert by_oid[1].hidden_s == pytest.approx(2.0)
    assert by_oid[1].slot_wait_s == pytest.approx(1.0)
    assert by_oid[1].service_s == pytest.approx(2.0)
    assert by_oid[1].session == "t"
    assert by_oid[2].outcome == "evicted"
    assert tr.counts()["outcome_hit"] == 1


def test_tracer_partial_miss_suppressed_and_demand_shape():
    tr = Tracer()
    # partial: load lands after the need
    tr.predicted([1], t=0.0)
    tr.dispatched([1], 0, tr.new_batch(), t=0.0)
    tr.claimed([1], 0, t=0.0)
    tr.loaded([1], 0, 0, 0.0, 0.0, 10.0)
    tr.demand(1, 0, needed_t=4.0, stall_s=6.0, full_load=False,
              disk_load_s=10.0, t=10.0)
    # suppressed: deduped before any claim
    tr.predicted([2], t=0.0)
    tr.dispatched([2], 0, tr.new_batch(), t=0.0)
    tr.suppressed([2], 0, t=1.0)
    # unpredicted demand miss gets the symmetric span shape
    tr.demand(3, 0, needed_t=5.0, stall_s=10.0, full_load=True,
              disk_load_s=10.0, t=15.0)
    spans = {s.oid: s for s in tr.spans()}
    assert check_span_invariants(list(spans.values())) == []
    assert spans[1].outcome == "partial"
    assert spans[1].hidden_s == pytest.approx(4.0)  # 10 - 6 waited out
    assert spans[2].outcome == "suppressed"
    assert spans[3].outcome == "miss" and spans[3].kind == "demand"
    assert spans[3].load_done_t == pytest.approx(15.0)


def test_span_refuses_a_second_terminal_state():
    tr = Tracer()
    tr.predicted([1], t=0.0)
    span = tr.spans()[0]
    tr.dropped([1], t=1.0)
    with pytest.raises(SpanError):
        tr._finish(span, "hit", 2.0)


def test_repeat_prediction_of_a_live_span_counts_re_predicted():
    tr = Tracer()
    tr.predicted([1], t=0.0)
    tr.predicted([1], t=1.0)
    tr.dispatched([1], 0, tr.new_batch(), t=1.0)
    tr.claimed([1], 0, t=1.0)
    tr.suppressed([1], 0, t=2.0)  # claimed: not terminal, another re-predict
    assert tr.active_count() == 1
    span = tr.spans()[0]
    assert span.re_predicted == 2
    tr.drop_active(t=3.0)
    assert tr.spans()[0].outcome == "dropped"


# ---------------------------------------------------------------------------
# span lifecycle on the live store (wall clock)
# ---------------------------------------------------------------------------

# real (small) sleeps: with a zero-latency model the demand path wins every
# race against the prefetch pool and no span ever reaches "hit"
_WALL_LAT = LatencyModel(disk_load=300e-6, remote_hop=120e-6, write_back=900e-6,
                         think=100e-6, parallel_per_ds=1)


@pytest.fixture(scope="module")
def wall_bank():
    wl = _catalog()["bank"]
    client = POSClient(n_services=4, latency=_WALL_LAT)
    obs = Observability(tracing=True)
    client.store.attach_obs(obs)
    client.register(wl.build_app())
    root = wl.populate(client.store)
    with client.session(wl.name, mode="capre", parallel_workers=8,
                        session_label="bank-wall") as s:
        wl.run_once(s, root)
        assert s.drain(10.0)
        # snapshot while the session is live: its runtime/<label> source is
        # registered now and unregistered on close (the lifecycle the
        # multi-tenant registry fix enforces)
        live_snap = obs.snapshot()
    client.store.reset_runtime_state()  # terminates never-demanded residents
    return obs, client, root, wl, live_snap


def test_live_store_spans_all_reach_exactly_one_terminal_state(wall_bank):
    obs, client, root, wl, _live_snap = wall_bank
    spans = obs.tracer.spans()
    assert spans and obs.tracer.active_count() == 0
    assert check_span_invariants(spans) == []
    outcomes = {sp.outcome for sp in spans}
    assert "hit" in outcomes
    assert all(sp.session == "bank-wall" for sp in spans)
    # a second run WITHOUT an orderly drain: reset_runtime_state hard-drains
    # the runtime and the invariant must still hold
    with client.session(wl.name, mode="capre", parallel_workers=8,
                        session_label="bank-wall") as s:
        wl.run_once(s, root)
    client.store.reset_runtime_state()
    assert obs.tracer.active_count() == 0
    assert check_span_invariants(obs.tracer.spans()) == []


def test_live_store_demand_stall_histograms_and_sources(wall_bank):
    obs, _client, _root, _wl, live_snap = wall_bank
    # a live session exposes its runtime as a source...
    assert any(k.startswith("runtime/") for k in live_snap["sources"])
    snap = obs.snapshot()
    assert "store" in snap["sources"]
    # ...and close() unregisters it: no leaked source pinning a shut-down
    # PrefetchRuntime after the session ends
    assert not any(k.startswith("runtime/") for k in snap["sources"])
    merged = obs.registry.merged_histogram("demand_stall_s")
    assert merged is not None and merged.count > 0
    assert snap["self"]["events"] > 0  # instrumentation metered itself
    assert snap["spans"]["active"] == 0


# ---------------------------------------------------------------------------
# virtual clock: replay spans, parity, percentile columns
# ---------------------------------------------------------------------------


def _virtual_bank(tracer=None, calibration=None):
    wl = _catalog()["bank"]
    client, _root, traces = record_workload(wl, runs=2)
    reg = client.logic_module.registered[wl.name]
    predictor = make_pos_predictor("static-capre", config=SessionConfig(rop_depth=2))
    predictor.warm(traces[0].accesses)
    return replay(traces[-1], predictor, client.store, reg, dispatch="batch",
                  tracer=tracer, calibration=calibration)


FULL_CHAIN = ("predicted_t", "dispatched_t", "claimed_t", "queued_t",
              "load_start_t", "load_done_t", "outcome_t")


def test_replay_spans_hold_the_same_invariants():
    tr = Tracer()
    _res = _virtual_bank(tracer=tr)
    spans = tr.spans()
    assert spans and tr.active_count() == 0
    assert check_span_invariants(spans) == []
    assert any(sp.fields_set() == FULL_CHAIN for sp in spans)


def test_wall_and_virtual_spans_populate_identical_fields(wall_bank):
    obs, _c, _r, _w, _snap = wall_bank
    tr = Tracer()
    _virtual_bank(tracer=tr)

    def hit_shapes(spans):
        return {sp.fields_set() for sp in spans
                if sp.kind == "prefetch" and sp.outcome == "hit"
                and sp.load_done_t is not None}

    wall, virt = hit_shapes(obs.tracer.spans()), hit_shapes(tr.spans())
    # the full lifecycle shape exists on both clocks, and neither clock
    # produces a hit-span shape the other cannot
    assert FULL_CHAIN in wall and FULL_CHAIN in virt
    assert wall == virt


def test_replay_result_carries_gated_percentile_columns():
    tr = Tracer()
    res = _virtual_bank(tracer=tr, calibration=Calibration(app_scales={"bank": 0.5}))
    assert 0.0 <= res.stall_p50_s <= res.stall_p99_s <= res.stall_p999_s
    assert res.stall_p999_s > 0.0  # bank always pays at least the cold miss
    assert res.calib_scale == pytest.approx(0.5)
    assert res.calibrated_stall_s == pytest.approx(res.stall_seconds * 0.5)
    for col in ("stall_p50_s", "stall_p99_s", "stall_p999_s", "calib_scale",
                "calibrated_stall_s", "obs_seconds", "obs_events"):
        assert col in CSV_COLUMNS
    # instrumentation charged itself to the ledger
    assert res.overhead["obs_events"] > 0
    assert res.overhead["obs_seconds"] >= 0.0


# ---------------------------------------------------------------------------
# Chrome-trace export
# ---------------------------------------------------------------------------


def test_chrome_trace_schema_and_phase_coverage(tmp_path):
    tr = Tracer()
    _virtual_bank(tracer=tr)
    spans = tr.spans()
    obj = chrome_trace(spans, clock="virtual")
    assert validate_chrome_trace(obj) == []
    json.dumps(obj)  # serializable end to end
    phases = full_lifecycle_phase_counts(obj)
    loaded = [s for s in spans if s.kind == "prefetch" and s.load_done_t is not None]
    assert loaded
    assert all(phases.get(s.oid, 0) >= 4 for s in loaded)
    path = tmp_path / "replay.trace.json"
    write_chrome_trace(str(path), spans, clock="virtual")
    with open(path) as f:
        round_tripped = json.load(f)
    assert validate_chrome_trace(round_tripped) == []
    # counter tracks made it out (disk occupancy and/or demand queue)
    assert any(ev["ph"] == "C" for ev in round_tripped["traceEvents"])


def test_validate_chrome_trace_rejects_malformed_events(tmp_path):
    assert validate_chrome_trace([]) != []  # not even a dict
    assert validate_chrome_trace({"events": []}) != []  # wrong key
    bad = {"traceEvents": [{"name": "x", "ph": "X", "ts": -1.0, "pid": 0,
                            "tid": 0, "dur": -2.0}]}
    problems = validate_chrome_trace(bad)
    assert any("ts" in p for p in problems)
    assert any("dur" in p for p in problems)
    # an empty span list still writes a *valid* (empty) trace — the writer
    # only raises when validation reports schema problems
    trace = write_chrome_trace(str(tmp_path / "empty.json"), [], clock="virtual")
    assert trace["traceEvents"] == []


def test_committed_baseline_carries_percentile_columns():
    import csv

    with open("artifacts/predict/baseline.csv", newline="") as f:
        fields = csv.DictReader(f).fieldnames
    for col in ("stall_p50_s", "stall_p99_s", "stall_p999_s",
                "calib_scale", "calibrated_stall_s"):
        assert col in fields
    # the port's writer emits the committed file's header, column for column
    assert list(CSV_COLUMNS) == fields


# ---------------------------------------------------------------------------
# calibration loader (single source of truth)
# ---------------------------------------------------------------------------


def test_calibration_loader_parses_fitted_scales(tmp_path):
    path = tmp_path / "calibration.csv"
    path.write_text(
        "app,workload,predictor,scale_app,scale_global\n"
        "bank,auditAll,capre,0.25,0.70\n"
        "oo7,traverse,capre,0.73,0.70\n"
    )
    cal = load_calibration(str(path))
    assert cal.fitted
    assert cal.scale_for("bank") == pytest.approx(0.25)
    assert cal.scale_for("oo7") == pytest.approx(0.73)
    assert cal.scale_for("unknown") == pytest.approx(0.70)  # global fallback
    model = calibrated_model("bank", base=REPLAY, calibration=cal)
    assert model.disk_load == pytest.approx(REPLAY.disk_load * 0.25)
    assert model.parallel_per_ds == REPLAY.parallel_per_ds  # slots untouched
    # missing file: identity, never an error
    cal = load_calibration(str(tmp_path / "nope.csv"))
    assert not cal.fitted and cal.scale_for("bank") == 1.0
    # the committed artifact parses and fits every catalog app
    committed = load_calibration()
    assert committed.fitted and committed.scale_for("bank") > 0.0
    # the mutating bank traversal calibrates under its own key
    assert _calibration_app_key("bank", "setAllTransCustomers") == "bank_write"
    assert _calibration_app_key("bank", "auditAll") == "bank"
