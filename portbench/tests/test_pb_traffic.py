"""The generator: every seed offers the same requests in the same order,
and a seed fixes their tokens."""

import json
import math

import numpy as np
import pytest

from pb.spec import BENCH_DIR
from pb.traffic import Traffic

MIXES = {n: json.loads((BENCH_DIR / "traffic" / f"{n}.json").read_text()) for n in ("chat", "code")}
RATE, SECONDS, WARMUP = 1.4, 50.0, 12.0


def _requests(mix, seed, n=None):
    t = Traffic(mix, seed, 65024, RATE, SECONDS, WARMUP)
    n = n or (len(t.plan) if t.plan else 2 * mix["table"])
    return [t.request(i) for i in range(n)]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_schedule(name):
    a, b = _requests(MIXES[name], 4100000123), _requests(MIXES[name], 4100000123)
    assert [(r.prompt.tolist(), r.answer, r.due) for r in a] == [(r.prompt.tolist(), r.answer, r.due) for r in b]


def test_open_loop_windows_alike():
    """Every seed's window: the same 70 arrivals at the same times, with the
    same prompt and answer lengths; only the tokens differ."""
    win = []
    for seed in (1, 2**31 + 77):
        rs = [r for r in _requests(MIXES["chat"], seed) if WARMUP <= r.due < WARMUP + SECONDS]
        assert len(rs) == round(RATE * SECONDS) and rs[0].due == WARMUP
        warm = [r for r in _requests(MIXES["chat"], seed) if r.due < WARMUP]
        assert warm and all(0 <= r.due for r in warm)
        win.append(rs)
    a, b = win
    assert [(len(x.prompt), x.answer, x.due) for x in a] == [(len(y.prompt), y.answer, y.due) for y in b]
    assert any((x.prompt != y.prompt).any() for x, y in zip(a, b))
    gaps = np.diff([r.due for r in a] + [WARMUP + SECONDS])
    assert math.isclose(gaps.sum(), SECONDS) and len(set(np.round(gaps, 9))) == len(gaps)
    assert sorted(len(r.prompt) for r in a) != [len(r.prompt) for r in a]  # shuffled, not sorted


def test_closed_loop_tables():
    """Every pass through the tables offers each length once; two seeds send
    the same lengths in the same order, with other tokens."""
    mix = MIXES["code"]
    n = mix["table"]
    a, b = _requests(mix, 1), _requests(mix, 2**31 + 77)
    assert [(len(x.prompt), x.answer) for x in a] == [(len(y.prompt), y.answer) for y in b]
    assert any((x.prompt[:8] != y.prompt[:8]).any() for x, y in zip(a, b))
    first, second = a[:n], a[n:2 * n]
    assert sorted(len(r.prompt) for r in first) == sorted(len(r.prompt) for r in second)
    assert [len(r.prompt) for r in first] != [len(r.prompt) for r in second]
    assert sorted(r.answer for r in first) == sorted(r.answer for r in second)
    assert all(r.due == 0 for r in a)


@pytest.mark.parametrize("name", MIXES)
def test_lengths_within_the_mix(name):
    mix = MIXES[name]
    for r in _requests(mix, 9):
        assert mix["prompt"]["min"] <= len(r.prompt) <= mix["prompt"]["max"]
        assert mix["answer"]["min"] <= r.answer <= mix["answer"]["max"]
        assert len(r.prompt) + r.answer < mix["max_len"]
        assert r.prompt.min() >= 0 and r.prompt.max() < 65024
