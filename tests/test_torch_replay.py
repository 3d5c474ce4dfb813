"""The port's replay harness (``repro_torch.predict.evaluate``) and latency
calibration (``repro_torch.predict.calibration``) against the JAX
package's and the committed ``artifacts/predict/baseline.csv``, on the CPU.

Each package runs ``evaluate_apps`` itself with the trace cache off and
the committed calibration passed in, and writes its rows with its own
``write_csv``.  The virtual clock is deterministic, so the two files must
be equal as text in every column but the two a wall clock fills
(``train_seconds``, ``obs_seconds``).  On ``baseline.csv``'s grid (bank,
bank_write, wordcount and kmeans; every predictor; capacities 0, 64 and
256; ``lru`` and ``prefetch-aware``; per-oid and batch dispatch) the
port's 192 rows must also equal the committed file's.  Then the sweeps
the committed file does not cover (oo7 and pga, the other policies, a
shared budget, calibrated clocks, RFO off, another ROP depth) against
JAX's, the trace cache against the committed traces, and the calibration
loader against JAX's.
"""

import dataclasses
import json

import pytest

from repro.pos.latency import REPLAY as JREPLAY
from repro.predict.calibration import calibrated_model as jcalibrated_model
from repro.predict.evaluate import _catalog as jcatalog
from repro.predict.evaluate import record_workload as jrecord_workload
from repro_torch.pos.latency import REPLAY
from repro_torch.predict.calibration import calibrated_model, load_calibration
from repro_torch.predict.evaluate import _catalog, evaluate_apps, record_workload
from torch_pos_canon import GOLDEN, GOLDEN_DIR
from torch_replay_canon import (
    PACKAGES,
    ROOT,
    first_difference,
    masked_rows,
    module,
    replay_csv,
)

BASELINE_CSV = ROOT / "artifacts" / "predict" / "baseline.csv"
CALIBRATION_CSV = ROOT / "artifacts" / "predict" / "calibration.csv"
# the grid the committed baseline.csv was written from, and what keys a row
BASELINE_APPS = ("bank", "bank_write", "wordcount", "kmeans")
BASELINE_GRID = dict(cache_capacities=(0, 64, 256), policies=("lru", "prefetch-aware"),
                     dispatch_modes=("per-oid", "batch"))
ROW_KEY = ("app", "workload", "predictor", "cache_capacity", "policy", "dispatch")


def calibration(pkg: str):
    """The package's ``load_calibration`` of the committed file, found from
    this checkout rather than the working directory."""
    return module(pkg, "predict.calibration").load_calibration(str(CALIBRATION_CSV))


def committed_baseline() -> list[list[str]]:
    return masked_rows(BASELINE_CSV.read_text())


def keyed(rows: list[list[str]]) -> dict:
    """Rows (header first) keyed by ``ROW_KEY``."""
    header = rows[0]
    idx = [header.index(c) for c in ROW_KEY]
    out = {}
    for row in rows[1:]:
        key = tuple(row[i] for i in idx)
        assert key not in out, key
        out[key] = row
    return out


@pytest.fixture(scope="module")
def baseline_grid(tmp_path_factory):
    """Each package's ``evaluate_apps`` over ``baseline.csv``'s grid, as
    masked ``write_csv`` rows."""
    out = {}
    for pkg in PACKAGES:
        results = module(pkg, "predict.evaluate").evaluate_apps(
            apps=BASELINE_APPS, trace_cache=None, calibration=calibration(pkg),
            **BASELINE_GRID)
        out[pkg] = masked_rows(replay_csv(pkg, results, tmp_path_factory.mktemp("grid")))
    return out


def test_baseline_grid_header_and_row_count(baseline_grid):
    want = committed_baseline()
    for pkg in PACKAGES:
        assert baseline_grid[pkg][0] == want[0], pkg
        assert len(baseline_grid[pkg]) - 1 == len(want) - 1 == 192, pkg


def _rows_of(rows, app):
    wl = _catalog()[app]
    return {k: v for k, v in keyed(rows).items() if k[:2] == (wl.name, wl.workload)}


@pytest.mark.parametrize("app", BASELINE_APPS)
def test_baseline_grid_rows_equal_jax(app, baseline_grid):
    got = _rows_of(baseline_grid["repro_torch"], app)
    want = _rows_of(baseline_grid["repro"], app)
    assert len(got) == 48
    assert got == want


@pytest.mark.parametrize("app", BASELINE_APPS)
def test_baseline_grid_rows_equal_committed_baseline(app, baseline_grid):
    """The committed file's rows of this app, in every column as text but
    the wall-clock two."""
    got = _rows_of(baseline_grid["repro_torch"], app)
    want = _rows_of(committed_baseline(), app)
    assert len(want) == 48
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key


SWEEPS = {
    "oo7-capacities": ("oo7", dict(modes=("static-capre", "rop"), cache_capacities=(0, 32),
                                   policies=("lru", "prefetch-aware"))),
    "pga-batch": ("pga", dict(cache_capacities=(0, 32), dispatch_modes=("per-oid", "batch"))),
    "kmeans-shared-budget": ("kmeans", dict(cache_capacities=(64,), shared_budget=True,
                                            policies=("fifo", "clock", "lfu"))),
    "bank_write-calibrated": ("bank_write", dict(calibrated=True, cache_capacities=(0, 64))),
    "bank_write-no-rfo": ("bank_write", dict(rfo=False, cache_capacities=(0, 64),
                                             dispatch_modes=("batch",))),
    "wordcount-rop-depth": ("wordcount", dict(rop_depth=4, cache_capacities=(0, 16))),
}


@pytest.mark.parametrize("sweep", sorted(SWEEPS))
def test_sweep_rows_equal_jax(sweep, tmp_path):
    app, kw = SWEEPS[sweep]
    texts = {}
    for pkg in PACKAGES:
        results = module(pkg, "predict.evaluate").evaluate_apps(
            apps=(app,), trace_cache=None, calibration=calibration(pkg), **kw)
        texts[pkg] = masked_rows(replay_csv(pkg, results, tmp_path))
    assert len(texts["repro_torch"]) > 1
    assert texts["repro_torch"] == texts["repro"]


def test_command_line_rows_equal_jax(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.predict.evaluate --fast --no-trace-cache``
    (at one capacity, batch dispatch) writes JAX's ``replay.csv`` and
    prints JAX's table; run from the repository's root, both load the
    committed calibration."""
    monkeypatch.chdir(ROOT)
    printed, rows = {}, {}
    for pkg in PACKAGES:
        out = tmp_path / pkg
        module(pkg, "predict.evaluate").main(
            ["--fast", "--no-trace-cache", "--cache-capacity", "64", "--dispatch", "batch",
             "--out", str(out)])
        printed[pkg] = capsys.readouterr().out.replace(str(out), "<out>")
        rows[pkg] = masked_rows((out / "replay.csv").read_text())
    assert len(rows["repro_torch"]) - 1 == 4 * 4
    assert rows["repro_torch"] == rows["repro"]
    # the table's train_seconds column is a wall clock's: compare the rest
    strip = [line.rsplit(None, 1)[0] for line in printed["repro_torch"].splitlines()[1:-1]]
    assert strip == [line.rsplit(None, 1)[0] for line in printed["repro"].splitlines()[1:-1]]
    assert printed["repro_torch"].splitlines()[-1] == "# wrote <out>/replay.csv (16 rows)"


def test_command_line_tenants_equal_jax(tmp_path, monkeypatch, capsys):
    """``--tenants`` runs the load simulator and writes JAX's
    ``loadgen.csv`` and summary."""
    monkeypatch.chdir(ROOT)
    printed, lines = {}, {}
    for pkg in PACKAGES:
        out = tmp_path / pkg
        module(pkg, "predict.evaluate").main(
            ["--tenants", "6", "--arrival", "poisson:500", "--jobs", "2", "--seed", "4",
             "--cache-capacity", "48", "--max-outstanding", "2", "--out", str(out)])
        printed[pkg] = capsys.readouterr().out.replace(str(out), "<out>")
        lines[pkg] = (out / "loadgen.csv").read_text()
    assert len(lines["repro_torch"].splitlines()) == 1 + 6 + 1
    assert lines["repro_torch"] == lines["repro"]
    assert printed["repro_torch"] == printed["repro"]


def test_evaluate_apps_rejects_an_unknown_app_as_jax_does():
    with pytest.raises(KeyError, match="unknown app 'nope'"):
        evaluate_apps(apps=("nope",), trace_cache=None)


# ---------------------------------------------------------------------------
# the trace cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", GOLDEN)
def test_trace_cache_file_equals_the_committed_trace(key, tmp_path):
    """``record_workload`` writing its cache into an empty directory writes
    the committed file byte for byte, and reading it back gives the
    recorded traces and store."""
    wl = _catalog()[key]
    _c, root, traces = record_workload(wl, runs=2, n_services=4, cache_dir=str(tmp_path))
    (path,) = tmp_path.iterdir()
    assert path.name == f"{key}_r2_ds4_v2.2.json"
    diff = first_difference(path.read_bytes(), (GOLDEN_DIR / path.name).read_bytes())
    assert diff is None, diff
    c2, root2, traces2 = record_workload(wl, runs=2, n_services=4, cache_dir=str(tmp_path))
    assert root2 == root
    assert [t.events for t in traces2] == [t.events for t in traces]


@pytest.mark.parametrize("key", ("bank_write", "oo7", "pga"))
def test_trace_cache_file_equals_jax(key, tmp_path):
    """The workloads without a committed trace: the port's cache file and
    JAX's are the same bytes."""
    record_workload(_catalog()[key], runs=2, cache_dir=str(tmp_path / "port"))
    jrecord_workload(jcatalog()[key], runs=2, cache_dir=str(tmp_path / "jax"))
    (mine,) = (tmp_path / "port").iterdir()
    (theirs,) = (tmp_path / "jax").iterdir()
    assert mine.name == theirs.name
    diff = first_difference(mine.read_bytes(), theirs.read_bytes())
    assert diff is None, diff


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def test_committed_calibration_equals_jax():
    got, want = calibration("repro_torch"), calibration("repro")
    assert got.fitted and want.fitted
    assert json.dumps(dataclasses.asdict(got), sort_keys=True) == json.dumps(
        dataclasses.asdict(want), sort_keys=True)
    assert got.source == str(CALIBRATION_CSV)


@pytest.mark.parametrize("app", sorted(_catalog()))
def test_calibrated_model_equals_jax(app):
    got = calibrated_model(app, base=REPLAY, calibration=load_calibration(str(CALIBRATION_CSV)))
    want = jcalibrated_model(app, base=JREPLAY, calibration=calibration("repro"))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.parallel_per_ds == REPLAY.parallel_per_ds
