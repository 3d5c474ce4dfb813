"""A run end to end at the smoke configurations on the CPU (the look for a
chip skipped), and the command's refusal without a chip."""

import json
import math
import subprocess
import sys
import time

import pytest

import run
from pb import spec

DATA = spec.BENCH_DIR / "tests" / "data"
BENCH = spec.load_json(DATA / "BENCHMARK.json")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_smoke_run(name, trace):
    cell = spec.find_cell(name, BENCH, DATA)
    out = run.serve(cell, 2**33 + 5, 1.5, bool(trace), "cpu", time.perf_counter())["result"]
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checked"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    want = cell.per_layer if trace else cell.end_to_end
    names = {m["name"] for m in want}
    assert set(line["metrics"]) <= names
    for v in line["metrics"].values():
        assert math.isfinite(v["value"]) and v["unit"]
    if not trace:  # on the CPU the device's numbers are missing, the host's are there
        assert names - set(line["metrics"]) <= {"peak_mem_gb"}
    else:
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line


def test_refuses_without_a_chip():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload",
                        "chatglm3-6b.chat", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=spec.ROOT, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
