"""The continuous batcher's own spans (``repro_torch.obs.engine`` recorded by
``runtime.scheduler.ContinuousBatcher``) at the chatglm3 smoke config on
the CPU: tracing changes nothing served, costs no clock read when off, and
gives the span tree the scheduler's docstring names, on the clock of
``torch.profiler``'s events."""

import time
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models.model import Model
from repro_torch.obs.engine import EngineTrace
from repro_torch.runtime.scheduler import ContinuousBatcher, Request

torch.set_num_threads(2)  # beside the other test workers on the CPU

ADMIT_LAPS = ("admit.upload", "admit.prefill", "admit.handoff", "admit.read")
TICK_LAPS = ("tick.launch", "tick.read")


@pytest.fixture(scope="module")
def chatglm3():
    cfg = get_smoke_config("chatglm3_6b").replace(compute_dtype="float32")
    model = Model(cfg, device="cpu")
    return model, model.init_params(0)


def _requests(vocab: int) -> list:
    """Seven requests, more than the batcher's slots, of mixed lengths."""
    rng = np.random.default_rng(3)
    return [Request(rid=r, prompt=rng.integers(1, vocab, size=int(rng.integers(3, 12))),
                    max_new_tokens=int(rng.integers(1, 6))) for r in range(7)]


def _drain(chatglm3, trace=None) -> tuple:
    """(the batcher, its requests) after serving ``_requests`` to the end."""
    model, params = chatglm3
    b = ContinuousBatcher(model, params, batch_size=3, max_len=32, device="cpu", trace=trace)
    reqs = _requests(model.cfg.vocab_size)
    for r in reqs:
        b.submit(r)
    b.run_until_drained()
    return b, reqs


def test_tracing_changes_nothing_served(chatglm3):
    off, reqs_off = _drain(chatglm3)
    on, reqs_on = _drain(chatglm3, EngineTrace())
    assert [r.output for r in reqs_on] == [r.output for r in reqs_off]
    assert on.steps == off.steps
    for key in ("k", "v"):
        assert torch.equal(on.cache[key], off.cache[key])
    assert torch.equal(on.logits, off.logits)


def test_without_a_trace_the_batcher_reads_no_clock(chatglm3, monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(time, "time_ns", no_clock)
    b, reqs = _drain(chatglm3)
    assert all(r.done for r in reqs) and b.steps > 0
    with pytest.raises(AssertionError, match="the clock was read"):
        _drain(chatglm3, EngineTrace())  # the patch bites where a trace is given


def test_span_tree(chatglm3):
    trace = EngineTrace()
    b, reqs = _drain(chatglm3, trace)
    spans = trace.take()
    assert trace.take() == []  # handed over and cleared
    by_id = {s.id: s for s in spans}
    kids = defaultdict(list)
    for s in spans:
        assert 0 < s.start <= s.end
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start <= s.start and s.end <= p.end, (s, p)
            kids[s.parent].append(s)
    names = Counter(s.name for s in spans)
    steps = [s for s in spans if s.name == "engine.step"]
    admits = [s for s in spans if s.name == "engine.admit"]
    ticks = [s for s in spans if s.name == "engine.tick"]
    assert len(admits) == len(reqs) and len(ticks) == b.steps
    assert set(names) == {"engine.queue", "engine.step", "engine.admit", "engine.tick",
                          *ADMIT_LAPS, *TICK_LAPS}
    for s in steps:
        assert s.parent is None and s.attrs == {}
        assert {k.name for k in kids[s.id]} <= {"engine.admit", "engine.tick"}
    for laps, parents in ((ADMIT_LAPS, admits), (TICK_LAPS, ticks)):
        for p in parents:
            assert by_id[p.parent].name == "engine.step"
            got = sorted(kids[p.id], key=lambda k: k.start)
            assert tuple(k.name for k in got) == laps
            # the laps follow one another, an admission's from its start
            assert got[0].start == p.start or p.name == "engine.tick"
            assert all(a.end == b.start for a, b in zip(got, got[1:]))
    assert all(t.attrs == {} for t in ticks)
    for a in admits:  # no flash forward on the CPU
        assert a.attrs == {"S": len(reqs[a.rid].prompt), "flash": 0}
    queues = {s.rid: s for s in spans if s.name == "engine.queue"}
    assert sorted(queues) == sorted(r.rid for r in reqs)
    for a in admits:
        q = queues[a.rid]
        assert q.parent is None and q.end == a.start


def test_take_drains_and_a_raise_drops_what_it_left_open():
    trace = EngineTrace()
    outer = trace.begin("outer")
    t = trace.lap("first", outer.start)
    trace.begin("left open")
    assert [s.name for s in trace.take()] == ["first"]
    trace.end(outer, n=2)
    (s,) = trace.take()
    assert s.name == "outer" and s.attrs == {"n": 2} and s.end >= t
    inner = trace.begin("after")
    assert inner.parent is None  # the span left open went with its parent
    trace.add("top", 5, 9, rid=4, slot=1)
    (top,) = trace.take()
    assert (top.start, top.end, top.rid, top.attrs) == (5, 9, 4, {"slot": 1})


def test_spans_lie_on_the_profilers_clock():
    """A span around a large product holds the profiler's event for it, to
    within 0.5 ms at each end: both read ``time.time_ns``."""
    a, b = torch.randn(768, 768), torch.randn(768, 768)
    torch.mm(a, b)
    trace = EngineTrace()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        s = trace.begin("mm")
        torch.mm(a, b)
        trace.end(s)
    (e,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    slack = 500_000
    assert s.start - slack <= e.start_ns() and e.start_ns() + e.duration_ns() <= s.end + slack
    assert e.duration_ns() > (s.end - s.start) / 2


def test_spans_are_not_profiler_ranges(chatglm3):
    """The profiler sees none of the engine's spans: a range it records
    would be mirrored onto the device's timeline as work."""
    trace = EngineTrace()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _drain(chatglm3, trace)
    names = {s.name for s in trace.take()}
    seen = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "engine.step" in names and not names & seen
