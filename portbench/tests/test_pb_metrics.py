"""Each metric reader on a fixed record, against values worked out by hand."""

import math

import pytest

from pb import spec, work
from pb.engine import Record
from pb.stats import percentile, window_requests

CFG = spec.load_json(spec.BENCH_DIR / "tests" / "data" / "configs" / "chatglm3-smoke.json")


def record():
    """A window [10, 20) s.  Requests: A (due 9, before the window), B and
    C (due in it), D (due in it, never answered)."""
    rec = Record(cfg=CFG, t_open=10.0, t_close=20.0)
    rec.requests = [
        {"due": 9.0, "times": [9.5, 10.5, 11.0, 12.0]},
        {"due": 11.0, "times": [11.2, 11.6, 12.1]},
        {"due": 12.0, "times": [12.4, 19.9, 20.5]},
        {"due": 19.0, "times": []},
    ]
    rec.admissions = [(9.4, 9.5, 8, 0), (11.0, 11.2, 128, 2), (12.2, 12.4, 64, 0), (19.9, 20.3, 8, 0)]
    rec.steps = [(10.0, 10.5, 0), (10.5, 11.0, 0), (11.0, 11.6, 1), (11.6, 12.0, 0), (21.0, 22.0, 0)]
    rec.setup_s = 33.5
    rec.peak_bytes = 12_345_000_000
    rec.ticks = [([5, 1], [True, False]), ([6, 9], [True, True])]
    rec.trace = {"window_s": 4.0, "busy_s": 3.0, "admits": {1: 0.1},
                 "ticks": {0: (0.002, 0.0005), 1: (0.004, 0.001)}}
    return rec


def read(name):
    return spec.reader(name).read(record())


def test_end_to_end():
    # gaps ending in the window: A 1.0 (10.5), 0.5, 1.0; B 0.4, 0.5; C 7.5 (19.9); not 20.5
    assert read("tpot_ms") == pytest.approx(1e3 * (1.0 + 0.5 + 1.0 + 0.4 + 0.5 + 7.5) / 6)
    # tokens in [10, 20): A 3, B 3, C 2
    assert read("tokens_per_s") == pytest.approx(8 / 10)
    assert read("peak_mem_gb") == pytest.approx(12.345)
    assert read("setup_s") == 33.5
    # first tokens of the window's requests: B 0.2, C 0.4, D never (inf)
    assert read("ttft_p50_ms") == pytest.approx(400.0)


def test_ttft_median_counts_the_unanswered():
    rec = record()
    rec.requests[1]["times"] = []  # B unanswered too: C 0.4, B and D inf
    assert spec.reader("ttft_p50_ms").read(rec) == math.inf
    rec.requests = rec.requests[:2]  # B alone in the window, unanswered
    rec.requests[1]["times"] = [11.25]
    assert spec.reader("ttft_p50_ms").read(rec) == pytest.approx(250.0)


def test_percentile():
    """The sweep's ttft: B 0.2, C 0.4 and D unanswered (inf)."""
    rec = record()
    ttft = [(e["times"][0] - e["due"]) if e["times"] else math.inf for e in window_requests(rec)]
    assert percentile(ttft, 90) == math.inf
    assert percentile(ttft[:2], 90) == pytest.approx(0.2 + 0.9 * 0.2)
    assert percentile([3.0], 50) == 3.0


def test_engine_layers():
    # admissions starting in the window: 0.2, 0.2, 0.4 s
    assert read("admit_ms.chat") == pytest.approx(1e3 * 0.8 / 3)
    # time in admissions within [10, 20): 0.2 + 0.2 + 0.1
    assert read("admit_share.code") == pytest.approx(100 * 0.5 / 10)
    gaps = sorted([1.0, 0.5, 1.0, 0.4, 0.5, 7.5])
    pos = 5 * 0.95
    assert read("itl_p95_ms.chat") == pytest.approx(1e3 * (gaps[4] + (pos - 4) * (gaps[5] - gaps[4])))
    # steps in the window with no admission: 0.5, 0.5, 0.4
    assert read("decode_tick_ms.chat") == pytest.approx(1e3 * 1.4 / 3)


def test_device_layers():
    assert read("idle_share.chat") == pytest.approx(25.0)
    assert read("idle_share.code") == pytest.approx(25.0)
    assert spec.reader("idle_share.code").__file__ == str(spec.BENCH_DIR / "metrics" / "idle_share.py")
    f0, b0 = work.tick_work(CFG, [5])
    f1, b1 = work.tick_work(CFG, [6, 9])
    bound = sum(max(f / work.PEAK_FLOPS, b / work.PEAK_BYTES) for f, b in ((f0, b0), (f1, b1)))
    assert read("decode_step_mfu.chat") == pytest.approx(100 * bound / 0.006)
    L, KV, H, hd = CFG["n_layers"], CFG["n_kv_heads"], CFG["n_heads"], CFG["head_dim"]
    calls = [4 * 2 * H * hd + 2 * 2 * KV * hd * 6, 4 * 2 * H * hd + 2 * 2 * KV * hd * 15]
    assert read("flash_decode_roofline.chat") == pytest.approx(100 * L * sum(calls) / (work.PEAK_BYTES * 0.0015))
    S = 128
    flops = S * work.token_flops(CFG) + 4 * L * H * hd * S * (S + 1) // 2 + 2 * CFG["d_model"] * CFG["vocab_size"]
    assert read("prefill_mfu.code") == pytest.approx(100 * flops / (work.PEAK_FLOPS * 0.1))
    # admissions starting in the window: S 128 (flash), 64 and 8
    tri = {s: s * (s + 1) // 2 for s in (128, 64, 8)}
    assert read("flash_fwd_coverage.code") == pytest.approx(100 * tri[128] / sum(tri.values()))


def test_nothing_to_read():
    rec = Record(cfg=CFG, t_open=0.0, t_close=1.0)
    for name in ("admit_ms.chat", "decode_tick_ms.chat", "decode_step_mfu.chat", "prefill_mfu.code",
                 "flash_decode_roofline.chat", "flash_fwd_coverage.code", "idle_share.chat",
                 "itl_p95_ms.chat", "tpot_ms", "ttft_p50_ms", "peak_mem_gb"):
        assert spec.reader(name).read(rec) is None, name
