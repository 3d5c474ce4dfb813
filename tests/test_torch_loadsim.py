"""The port's multi-tenant load simulator (``repro_torch.predict.loadsim``)
against the JAX package's and the committed
``artifacts/predict/loadgen.csv``, on the CPU.

Each package records its own shared catalog and runs ``run_loadsim``; the
virtual clock is deterministic, so the rows each writes with its own
``write_loadgen_csv`` must be equal line for line.  With the arguments the
committed file's ``virtual`` rows were written with (128 tenants, Poisson
arrivals at 2,000 jobs/s, CAPre, batch dispatch, a 256-line shared LRU
budget, at most 8 outstanding emissions, admission threshold 0.5) the
port's 129 rows must also equal those rows.  Then a closed-arrival run
with an admission bound, and one under a crash with replication 2,
against JAX's.
"""

import pytest

from repro_torch.predict.loadsim import LOADGEN_COLUMNS, run_loadsim
from torch_replay_canon import PACKAGES, ROOT, module

LOADGEN_CSV = ROOT / "artifacts" / "predict" / "loadgen.csv"
# the arguments the committed loadgen.csv's virtual rows were written with
LOADGEN_ARGS = dict(tenants=128, arrival="poisson:2000", jobs=1, seed=0, mode="capre",
                    dispatch="batch", cache_capacity=256, shared_budget=True,
                    policy="lru", max_outstanding=8, admission_threshold=0.5)


def loadgen_lines(pkg: str, report, tmp_path) -> list[str]:
    """The package's ``write_loadgen_csv`` of ``report``'s rows, as lines."""
    path = tmp_path / pkg / "loadgen.csv"
    module(pkg, "predict.loadsim").write_loadgen_csv(str(path), report.rows())
    return path.read_text().splitlines()


def committed_virtual_loadgen() -> tuple[str, list[str]]:
    """The committed loadgen.csv's header and its ``virtual`` rows."""
    lines = LOADGEN_CSV.read_text().splitlines()
    return lines[0], [line for line in lines[1:] if line.startswith("virtual,")]


@pytest.fixture(scope="module")
def committed_args_lines(tmp_path_factory):
    return loadgen_lines("repro_torch", run_loadsim(**LOADGEN_ARGS),
                         tmp_path_factory.mktemp("loadgen"))


def test_committed_args_reproduce_the_virtual_rows(committed_args_lines):
    header, want = committed_virtual_loadgen()
    assert committed_args_lines[0] == header == ",".join(LOADGEN_COLUMNS)
    assert len(want) == 129
    assert committed_args_lines[1:] == want


def test_committed_args_rows_equal_jax(committed_args_lines, tmp_path):
    jreport = module("repro", "predict.loadsim").run_loadsim(**LOADGEN_ARGS)
    assert committed_args_lines == loadgen_lines("repro", jreport, tmp_path)


CASES = {
    "closed-bounded": dict(tenants=12, arrival="closed", jobs=2, seed=3,
                           mix=("bank", "wordcount", "kmeans", "bank_write"),
                           cache_capacity=48, shared_budget=True, policy="prefetch-aware",
                           max_outstanding=2, admission_threshold=0.5),
    "poisson-crash": dict(tenants=8, arrival="poisson:800", jobs=2, seed=9,
                          mix=("bank", "bank_write", "oo7"), cache_capacity=64,
                          scenario="crash", replication=2, write_quorum=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rows_equal_jax(case, tmp_path):
    lines = {pkg: loadgen_lines(pkg, module(pkg, "predict.loadsim").run_loadsim(**CASES[case]),
                                tmp_path / case)
             for pkg in PACKAGES}
    got = lines["repro_torch"]
    assert len(got) == 1 + CASES[case]["tenants"] + 1
    assert got[-1].split(",")[LOADGEN_COLUMNS.index("tenant")] == "ALL"
    assert got == lines["repro"]


def test_closed_bounded_run_sheds():
    """The admission bound binds in the closed-arrival case above, so its
    comparison covers the shedding path."""
    report = run_loadsim(**CASES["closed-bounded"])
    assert sum(t.admission_shed for t in report.per_tenant) > 0
