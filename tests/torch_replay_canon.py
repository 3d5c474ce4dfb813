"""Plain forms of the replay harness's output, for holding the port's
``repro_torch.predict.{evaluate,loadsim}`` and ``repro_torch.obs.export``
against the JAX package's.

Objects never cross the packages, so each package runs its own call and
writes its own artifact, and the tests compare text: ``write_csv`` rows
(less the wall-clock columns), ``write_loadgen_csv`` lines and
``json.dumps(..., sort_keys=True)`` of a Chrome trace.  Every recording
runs with the trace cache off.
"""

from __future__ import annotations

import csv
import importlib
import io
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("repro_torch", "repro")
# the columns of a replay CSV that a wall clock fills
WALL_COLUMNS = ("train_seconds", "obs_seconds")


def module(pkg: str, name: str):
    """``<pkg>.<name>``, e.g. ``module("repro", "predict.evaluate")``."""
    return importlib.import_module(f"{pkg}.{name}")


def masked_rows(text: str) -> list[list[str]]:
    """A ``write_csv`` file's rows (header first), the wall-clock cells
    blanked."""
    rows = list(csv.reader(io.StringIO(text)))
    cols = [rows[0].index(c) for c in WALL_COLUMNS]
    for row in rows[1:]:
        for col in cols:
            row[col] = ""
    return rows


def replay_csv(pkg: str, results, tmp_path) -> str:
    """The package's ``write_csv`` of ``results``, as text."""
    path = tmp_path / pkg / "replay.csv"
    module(pkg, "predict.evaluate").write_csv(results, str(path))
    return path.read_text()


def first_difference(got, want, context: int = 60):
    """``None`` when two texts (or byte strings) are equal, else where
    they first part, with a little of each around it: a short message in
    place of pytest's diff, which on a half-megabyte line runs for
    minutes."""
    if got == want:
        return None
    i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
    lo = max(0, i - context)
    return (f"lengths {len(got)} and {len(want)}, first difference at {i}: "
            f"{got[lo:i + context]!r} against {want[lo:i + context]!r}")
