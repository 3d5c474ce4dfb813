"""The comparison fails what it should: the fp8 control, and a run whose
timed path is broken underneath in each way a serving cell can break (a
decode step that leaves its cache as it was; half of the batch left out,
the mean of the other half's logits in its place; every served token
altered where it is produced), and for the moe family a run whose experts
drop pairs (the registry's capacity_factor 1.25: capacity 1 at the smoke
cell's 4-row tick).  The runs skip the look for a chip and run on the CPU
at the smoke configurations, against the limits in tests/data/cells/."""

import time

import pytest

import run
from pb import spec

DATA = spec.BENCH_DIR / "tests" / "data"
BENCH = spec.load_json(DATA / "BENCHMARK.json")
CELLS = ["chatglm3-smoke.chat-smoke", "qwen3moe-smoke.chat-smoke"]
SEED = 31


def serve(name, control=False, **config):
    cell = spec.find_cell(name, BENCH, DATA)
    cell.config.update(config)
    return run.serve(cell, SEED, 1.5, False, "cpu", time.perf_counter(), control=control)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    r = serve(name, control=True)
    assert r["result"]["correct"]
    limits = r["result"]["checked"]
    assert any(r["control"][k] > v["limit"] for k, v in limits.items()), r["control"]


def _stale(real):
    def step(self, params, cache, tokens, kv_lens):
        logits, _ = real(self, params, {k: v.clone() for k, v in cache.items()}, tokens, kv_lens)
        return logits, cache
    return step


def _half(real):
    """Every other row of the batch left out: the rest computed (their cache
    rows written), the left-out rows given the mean of the rest's logits."""
    def step(self, params, cache, tokens, kv_lens):
        kept = {k: v[:, 0::2].clone() for k, v in cache.items()}
        logits, kept = real(self, params, kept, tokens[0::2], kv_lens[0::2])
        for k, v in cache.items():
            v[:, 0::2] = kept[k]
        out = logits.mean(0, keepdim=True).expand(tokens.shape[0], *logits.shape[1:]).clone()
        out[0::2] = logits
        return out, cache
    return step


FAULTS = [(c, f) for c in CELLS for f in ("stale", "half", "token")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_fails(name, fault, monkeypatch):
    from repro_torch.runtime.scheduler import ContinuousBatcher

    if fault == "token":
        real = ContinuousBatcher._decode
        monkeypatch.setattr(ContinuousBatcher, "_decode",
                            lambda self, tokens, lens: (real(self, tokens, lens) + 1) % 128)
    else:
        wrap = {"stale": _stale, "half": _half}[fault]
        monkeypatch.setattr(ContinuousBatcher, "_decode_step", wrap(ContinuousBatcher._decode_step))
    assert not serve(name)["result"]["correct"]


def test_dropping_experts_fail():
    """The moe cell served with capacity_factor 1.25: at the tick each
    expert takes one (token, choice) pair, the others are dropped, and the
    check, whose reference drops nothing, reads it."""
    r = serve("qwen3moe-smoke.chat-smoke", capacity_factor=1.25)
    assert not r["result"]["correct"], r["program"]
