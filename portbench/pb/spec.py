"""A workload's files, found by name.

``BENCHMARK.json`` at the checkout's root lists each cell as
``{name, config, traffic, chips, why}``.  The harness resolves a cell to

- ``configs/<config>.json``: the model's sizes as they are run, read by the
  program's configuration and by the plain reference alike;
- ``traffic/<traffic>.json``: the traffic mix's parameters, read by the one
  generator in ``traffic.py``;
- ``cells/<name>.json``: what belongs to the pair, such as a chat cell's
  offered rate, its warm-up and the limits of its comparison;

and each metric to ``metrics/<metric>.py``, whose ``read(record)`` returns
the metric's value or None (a metric split by the traffic it moves, such
as ``idle_share.chat`` and ``idle_share.code``, shares
``metrics/idle_share.py`` where it has no file of its own).  A new cell,
mix or metric is new files and new entries: no file is edited.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    cell: dict
    end_to_end: list  # the BENCHMARK.json entries of the metrics this cell reports
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, workload: str) -> bool:
    """Whether ``workload`` reports ``metric``: those with a ``workloads``
    list name their cells, the others are reported by every cell."""
    return workload in metric.get("workloads", [workload])


def find_cell(name: str, bench: dict | None = None, data: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json`` by default) with
    its configuration, traffic and cell files read from ``data``."""
    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"workload {name!r} is not in the benchmark")
    w = entries[0]
    return Cell(
        name=name,
        chips=w["chips"],
        config=load_json(data / "configs" / f"{w['config']}.json"),
        traffic=load_json(data / "traffic" / f"{w['traffic']}.json"),
        cell=load_json(data / "cells" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
    )


def reader(metric: str):
    """The module ``metrics/<metric>.py``, or else ``metrics/<stem>.py`` for
    ``<stem>.<suffix>``; its ``read(record)`` gives the metric's value, or
    None where the record holds nothing to read."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = path.with_name(f"{metric.rsplit('.', 1)[0]}.py")
    spec = importlib.util.spec_from_file_location(f"pb_metric_{metric.replace('.', '_')}", path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
