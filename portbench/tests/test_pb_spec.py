"""BENCHMARK.json's cells and metrics resolve to their files by name, and
the configuration files are the program's models as it registers them: a
key the file sets away from the registry (qwen3-moe-30b-a3b's dropless
capacity_factor) is one the file lists under ``assumed``."""

import pytest

from pb import spec, weights

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(w):
    cell = spec.find_cell(w["name"], BENCH)
    assert cell.config["name"] == w["config"]
    assert cell.end_to_end and cell.per_layer
    assert "setup_s" in [m["name"] for m in cell.end_to_end]
    assert {"warmup_s", "check", "limits"} <= set(cell.cell)
    assert ("rate_rps" in cell.cell) == (cell.traffic["loop"] == "open")


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_has_a_reader(m):
    assert callable(spec.reader(m["name"]).read)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_is_the_programs(c):
    import run
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    cfg = spec.load_json(spec.ROOT / c["file"])
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    want = get_config(cfg["model"])
    got = run.program_config(cfg)
    assumed = {a.split(":")[0] for a in cfg.get("assumed", [])}
    for key in run.PROGRAM_KEYS:
        if key != "attn_impl" and key in cfg and getattr(got, key) != getattr(want, key):
            assert key in assumed, key
            assert getattr(got, key) == cfg[key], key
    assert got.attn_impl == "pallas" and got.compute_dtype == "bfloat16"
    shapes = {p: tuple(t.shape) for p, t in weights.leaves(Model(got, device="meta").abstract_params())}
    assert shapes == {p: s for p, (s, _, _) in weights.layout(cfg).items()}
