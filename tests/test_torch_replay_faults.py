"""The port's replay under placement policies and faults
(``repro_torch.predict.evaluate.evaluate_workload``) against the JAX
package's, on the CPU.

The sweep of ``benchmarks/bench_placement.py:run_matrix`` at its defaults:
bank and oo7, ``static-capre`` and ``rop``, batch dispatch, every
placement at replication 2, under no fault, a straggler and a crash.  Then
one mutating app (bank_write) under the recovery regimes (``crash+revive``,
``partition``, ``straggler+hedge``) at write quorums 1 and 2.  Each
package records its own workload with the trace cache off and writes its
rows with its own ``write_csv``; the virtual clock is deterministic, so
the rows must be equal as text in every column but the two a wall clock
fills.  The committed ``placement.csv`` is older than the JAX package's
writer, so the port is held to JAX's live output, not to that file.
"""

import pytest

from repro_torch.pos.placement import available_placements
from torch_replay_canon import PACKAGES, masked_rows, module, replay_csv


def _rows(app: str, tmp_path, **kw) -> dict:
    """Each package's ``evaluate_workload`` of ``app`` (which records it
    afresh, with no trace cache), as masked ``write_csv`` rows."""
    out = {}
    for pkg in PACKAGES:
        ev = module(pkg, "predict.evaluate")
        results = ev.evaluate_workload(ev._catalog()[app], **kw)
        out[pkg] = masked_rows(replay_csv(pkg, results, tmp_path))
    return out


def test_placements_equal_jax():
    from repro.pos.placement import available_placements as javailable_placements

    assert available_placements() == javailable_placements()
    assert len(available_placements()) >= 3


@pytest.mark.parametrize("placement", available_placements())
@pytest.mark.parametrize("app", ("bank", "oo7"))
def test_placement_matrix_rows_equal_jax(app, placement, tmp_path):
    rows = _rows(app, tmp_path, modes=("static-capre", "rop"), dispatch_modes=("batch",),
                 placement=placement, replication=2,
                 scenarios=("no-fault", "straggler", "crash"))
    got = rows["repro_torch"]
    assert len(got) - 1 == 2 * 3
    header = got[0]
    col = {c: header.index(c) for c in ("placement", "replication", "scenario", "failovers")}
    assert {r[col["placement"]] for r in got[1:]} == {placement}
    assert {r[col["replication"]] for r in got[1:]} == {"2"}
    assert [r[col["scenario"]] for r in got[1:]] == ["no-fault"] * 2 + ["straggler"] * 2 + [
        "crash"] * 2
    # the crash lands mid-run and someone fails over
    assert any(int(r[col["failovers"]]) > 0 for r in got[1:] if r[col["scenario"]] == "crash")
    assert got == rows["repro"]


@pytest.mark.parametrize("scenario", ("crash+revive", "partition", "straggler+hedge"))
def test_recovery_regime_rows_equal_jax(scenario, tmp_path):
    rows = _rows("bank_write", tmp_path, replication=2, scenarios=(scenario,),
                 write_quorums=(1, 2), dispatch_modes=("batch",))
    got = rows["repro_torch"]
    header = got[0]
    wq = header.index("write_quorum")
    n_modes = len(module("repro_torch", "predict").available(kind="pos"))
    assert len(got) - 1 == 2 * n_modes
    assert sorted({r[wq] for r in got[1:]}) == ["1", "2"]
    assert got == rows["repro"]
