"""The port's plan-driven weight streamer (``repro_torch.runtime.prefetch``)
against the JAX package's, on the CPU, with the modeled host store
(``HostParamStore(device="cpu")``: a fetch sleeps its modeled transfer
time, as the JAX store's does, so the tests mean what JAX's mean).

Twins of tests/test_access_plan.py:100-147 (the MoE loss plan there, and
the dense ``loss_fn`` plan beside it), tests/test_predict.py:343-380,
tests/test_multitenant.py:175-210, tests/test_obs.py:484-504 and
tests/test_batch_dispatch.py:581; a traced run whose spans each reach one
terminal state; the deterministic counters of one JAX run and one port run
of the same plan and mode; and a streamed decode step equal to the
resident one.  Parameters come from JAX's ``Model.init_params`` through
``repro_torch.convert``.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # beside the other test workers on the CPU

from repro.configs import get_smoke_config as jget_smoke
from repro.core.access_plan import build_access_plan as jbuild_access_plan
from repro.launch.serve import Server as JServer
from repro.models.model import Model as JModel
from repro.runtime.prefetch import HostParamStore as JHostParamStore
from repro.runtime.prefetch import WeightStreamer as JWeightStreamer
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_numpy_tree
from repro_torch.core.access_plan import AccessRecord, PrefetchPlan, build_access_plan
from repro_torch.launch.serve import Server
from repro_torch.launch.steps import concrete_batch
from repro_torch.models.model import Model
from repro_torch.obs import Registry, Tracer, check_span_invariants
from repro_torch.runtime.prefetch import STREAM_PID, HostParamStore, WeightStreamer


def _jax_params(cfg_name: str, seed: int = 0, **overrides):
    """(JAX params, the same values as the port's tensor tree)."""
    jparams = JModel(jget_smoke(cfg_name).replace(**overrides)).init_params(
        jax.random.PRNGKey(seed))
    return jparams, from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")


def _decode_plan(model: Model, batch: int = 2, cache_len: int = 16, pos: int = 8):
    return build_access_plan(
        lambda p, c, t: model.decode_step(p, c, t, pos),
        model.abstract_params(),
        model.abstract_cache(batch, cache_len),
        torch.empty((batch, 1), dtype=torch.int64, device="meta"),
    )


# ---------------------------------------------------------------------------
# tests/test_access_plan.py:100-147
# ---------------------------------------------------------------------------


def test_weight_streaming_capre_beats_rop_and_none():
    """The JAX twin's setting, with a modeled fetch latency of 3 ms instead
    of 0.5 ms: the gaps it checks (capre overlaps ten serial layer fetches
    that rop and on-demand wait out) then span ~30 ms instead of ~6 ms, so
    thread wake-ups delayed by other test workers on a loaded CPU do not
    close them."""
    cfg = get_smoke_config("yi_34b").replace(n_layers=8)
    model = Model(cfg, device="cpu")
    _, params = _jax_params("yi_34b", n_layers=8)
    plan = _decode_plan(model)
    walls, metrics = {}, {}
    for mode in (None, "rop", "capre"):
        store = HostParamStore(params, bandwidth_gbps=2.0, base_latency_s=3e-3, device="cpu")
        ws = WeightStreamer(store, plan=plan, mode=mode, k_ahead=3, workers=8)
        walls[mode] = ws.run_plan(compute_s_per_group=2e-3)
        metrics[mode] = ws.metrics
        ws.close()
    assert walls["capre"] < walls[None], walls
    assert walls["capre"] < walls["rop"], walls
    # the plan-driven mode overlaps almost everything
    assert metrics["capre"].prefetch_hits > metrics["rop"].prefetch_hits


@pytest.mark.parametrize("arch,records,collections", [
    ("qwen1_5_4b", 15, 12),             # the dense loss
    ("granite_moe_1b_a400m", 12, 10),   # the JAX twin's own: an MoE loss, tied head
])
def test_streaming_correctness_all_params_served(arch, records, collections):
    """The training loss's plan has JAX's records (paths, shapes, bytes,
    collection flags), and every record is served with its shape; the moe
    case's records include the router and the three expert banks, each as
    one stacked collection."""
    cfg = get_smoke_config(arch)
    model = Model(cfg, device="cpu")
    _, params = _jax_params(arch, seed=1)
    tokens = torch.empty((2, 8), dtype=torch.int64, device="meta")
    plan = build_access_plan(lambda p, b: model.loss_fn(p, b), model.abstract_params(),
                             {"inputs": tokens, "targets": tokens})
    assert len(plan.records) == records and len(plan.collections()) == collections
    jtok = jax.ShapeDtypeStruct((2, 8), jnp.int32)
    jmodel = JModel(jget_smoke(arch))
    jplan = jbuild_access_plan(lambda p, b: jmodel.loss_fn(p, b), jmodel.abstract_params(),
                               {"inputs": jtok, "targets": jtok})
    assert ({r.path: (tuple(r.shape), r.nbytes, r.collection) for r in plan.records}
            == {r.path: (tuple(r.shape), r.nbytes, r.collection) for r in jplan.records})
    store = HostParamStore(params, bandwidth_gbps=50.0, base_latency_s=1e-5, device="cpu")
    ws = WeightStreamer(store, plan=plan, mode="capre", k_ahead=2)
    seen = {}

    def compute(gi, arrays):
        seen.update({k: tuple(v.shape) for k, v in arrays.items()})

    ws.run_plan(compute_fn=compute)
    ws.close()
    for rec in plan.records:
        assert seen[rec.path] == rec.shape


# ---------------------------------------------------------------------------
# tests/test_predict.py:343-380
# ---------------------------------------------------------------------------


def _tiny_streamer(mode=None, **kw):
    params = {"g0": torch.zeros(64), "g1": torch.ones(64)}
    plan = PrefetchPlan(records=[
        AccessRecord(path="g0", first_use=0, nbytes=256, shape=(64,)),
        AccessRecord(path="g1", first_use=1, nbytes=256, shape=(64,)),
    ])
    store = HostParamStore(params, bandwidth_gbps=100.0, base_latency_s=0.0, device="cpu")
    return WeightStreamer(store, plan=plan, mode=mode, **kw)


def _drain(ws):
    """A compute_fn that waits out every in-flight fetch, so whether a
    prefetch lands before the next get() is no scheduling race."""
    def compute(_gi, _arrays):
        while True:
            with ws._lock:
                evs = list(ws._inflight.values())
            if not evs:
                return
            for ev in evs:
                ev.wait(5.0)
    return compute


def test_wasted_bytes_charged_at_eviction_time():
    ws = _tiny_streamer(mode=None)
    ws._fetch_async("g0")  # prefetched…
    deadline = time.time() + 5.0
    while "g0" not in ws._cache and time.time() < deadline:
        time.sleep(0.001)
    ws._evict_before(1)  # …then evicted without ever being served
    assert ws.metrics.wasted_bytes == 256
    ws.close()


def test_used_arrays_not_counted_as_waste():
    ws = _tiny_streamer(mode="capre")
    ws.run_plan()
    assert ws.metrics.wasted_bytes == 0
    assert ws.metrics.stalls <= 2
    ws.close()


def test_streamer_resolves_modes_through_registry():
    with pytest.raises(KeyError, match="unknown prefetch mode"):
        _tiny_streamer(mode="nope")
    ws = _tiny_streamer(mode="markov-miner", warm_group_trace=[-1, 0, 1])
    ws.run_plan(compute_fn=_drain(ws))
    assert ws.metrics.prefetch_hits >= 1  # mined -1->0->1 transitions fired
    ws.close()


# ---------------------------------------------------------------------------
# tests/test_multitenant.py:175-210
# ---------------------------------------------------------------------------


class _StallingStore:
    """First fetch blocks until released (a stuck pool lane); later
    fetches (the demand-path fallback) return immediately."""

    def __init__(self):
        self.arr = torch.ones((8,))
        self.release = threading.Event()
        self._lock = threading.Lock()
        self.calls = 0

    def fetch(self, path):
        with self._lock:
            self.calls += 1
            first = self.calls == 1
        if first:
            self.release.wait(10.0)
        return self.arr

    def nbytes(self, path):
        return self.arr.nbytes


def test_streamer_timeout_serves_fallback_and_counts_it():
    store = _StallingStore()
    ws = WeightStreamer(store, plan=None, mode=None, workers=1, fetch_timeout=0.05)
    try:
        ws.fetch_group(["w"])  # lane 0 wedges on the first fetch
        t0 = time.perf_counter()
        arr = ws.get("w")
        assert arr.shape == (8,)
        assert ws.metrics.fetch_timeouts == 1
        assert ws.metrics.stalls == 1
        assert store.calls == 2  # async lane + sync fallback
        assert time.perf_counter() - t0 < 5.0
        # once the wedged lane lands, later gets are plain cache hits
        store.release.set()
        assert ws.get("w").shape == (8,)
        assert ws.metrics.fetch_timeouts == 1
    finally:
        store.release.set()
        ws.close()


def test_streamer_workers_zero_still_constructs_a_pool():
    store = _StallingStore()
    store.release.set()  # nothing should block in this test
    ws = WeightStreamer(store, plan=None, mode=None, workers=0)
    try:
        assert ws.get("w").shape == (8,)
    finally:
        ws.close()


# ---------------------------------------------------------------------------
# tests/test_obs.py:484-504 and tests/test_batch_dispatch.py:581
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dispatch", ["batch", "per-oid"])
def test_weight_streamer_records_through_the_registry(dispatch):
    params = {"a": torch.ones((64,)), "b": torch.ones((64,)), "c": torch.ones((64,))}
    store = HostParamStore(params, bandwidth_gbps=100.0, base_latency_s=1e-5, device="cpu")
    reg = Registry()
    ws = WeightStreamer(store, plan=None, mode=None, workers=2, dispatch=dispatch, registry=reg)
    try:
        ws.fetch_group(["a", "b"])
        ws.fetch_group(["a", "b"])  # in flight or cached: all suppressed
        assert ws.get("a").shape == (64,)
        assert ws.get("c").shape == (64,)  # pure demand fetch
    finally:
        ws.close()
    assert ws.metrics.dedup_suppressed >= 2
    assert ws.metrics.batch_dispatches >= (2 if dispatch == "per-oid" else 1)
    snap = reg.snapshot()
    assert snap["sources"]["stream"]["fetches"] == ws.metrics.fetches
    hist = reg.merged_histogram("stream_stall_s")
    assert hist is not None and hist.count >= 2  # every get recorded


def test_weight_streamer_fetch_group_dedupes_and_fetches():
    params = {f"layer{i}": {"w": torch.ones((4, 4))} for i in range(4)}
    store = HostParamStore(params, bandwidth_gbps=1000.0, base_latency_s=0.0, device="cpu")
    streamer = WeightStreamer(store, plan=None, mode=None, workers=2)
    paths = sorted(store.arrays)
    streamer.fetch_group(paths[:2])
    streamer.fetch_group(paths[:3])  # first two suppressed (cached/in-flight)
    for p in paths[:3]:
        streamer.get(p)
    assert streamer.metrics.fetches == 3
    assert streamer.metrics.dedup_suppressed == 2
    assert streamer.metrics.batch_dispatches >= 2
    streamer.close()


def test_concurrent_fetch_groups_fetch_each_path_once():
    """More lanes than cores and a short switch interval: many overlapping
    batched and per-path prefetches and demand gets from several threads
    still fetch each path exactly once (the one-snapshot dedupe under the
    streamer's lock) and serve every get its own leaf."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    params = {f"p{i:02d}": torch.full((16,), float(i)) for i in range(40)}
    store = HostParamStore(params, bandwidth_gbps=1e3, base_latency_s=1e-4, device="cpu")
    ws = WeightStreamer(store, plan=None, mode=None, workers=16)
    paths = sorted(params)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def client(k):
            for j in range(40):
                ws.fetch_group(paths[(j + k) % 40 : (j + k) % 40 + 7])
                p = paths[(j * 3 + k) % 40]
                assert torch.equal(ws.get(p), params[p])
            return k

        with ThreadPoolExecutor(max_workers=12) as pool:
            assert sorted(pool.map(client, range(12)), key=int) == list(range(12))
        for p in paths:
            assert torch.equal(ws.get(p), params[p])
    finally:
        sys.setswitchinterval(old)
        ws.close()
    assert ws.metrics.fetches == len(paths)
    assert ws.metrics.bytes_moved == sum(t.nbytes for t in params.values())
    assert ws.metrics.fetch_timeouts == 0


# ---------------------------------------------------------------------------
# spans, counters against JAX, a streamed decode step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["capre", "rop", None])
def test_traced_run_spans_reach_one_terminal_state(mode):
    cfg = get_smoke_config("chatglm3_6b")
    model = Model(cfg, device="cpu")
    _, params = _jax_params("chatglm3_6b")
    plan = _decode_plan(model)
    tracer = Tracer()
    store = HostParamStore(params, bandwidth_gbps=20.0, base_latency_s=1e-4, device="cpu")
    ws = WeightStreamer(store, plan=plan, mode=mode, k_ahead=2, workers=4, tracer=tracer)
    ws.run_plan(compute_s_per_group=1e-3)
    ws.close()
    spans = tracer.spans()
    assert spans and tracer.active_count() == 0
    assert check_span_invariants(spans) == []
    assert all(s.terminal for s in spans)
    # one span per planned path in a plan-driven run: each predicted, then
    # served as a hit or partial (or missed on demand), never twice
    counts = tracer.counts()
    if mode == "capre":
        assert {s.oid for s in spans if s.kind == "prefetch"} == set(range(len(plan.records)))
        assert counts.get("outcome_hit", 0) + counts.get("outcome_partial", 0) >= 1
    if mode is None:
        assert all(s.kind == "demand" and s.outcome == "miss" for s in spans)
        assert len(spans) == len(plan.records)
    assert all(s.service == STREAM_PID for s in spans)


_COUNTERS = ("fetches", "bytes_moved", "wasted_bytes", "batch_dispatches", "dedup_suppressed",
             "fetch_timeouts")


@pytest.mark.parametrize("mode", [None, "rop", "capre", "markov-miner", "hybrid"])
@pytest.mark.parametrize("dispatch", ["batch", "per-oid"])
def test_deterministic_counters_match_jax(mode, dispatch):
    """One JAX run and one port run of the same decode plan (each package's
    own trace of the same config) and mode, on zero-latency stores, with a
    compute step that drains the in-flight fetches: the counters that do not
    depend on timing are equal."""
    arch = "chatglm3_6b"
    jparams, params = _jax_params(arch)
    jplan = JServer(jget_smoke(arch), max_len=64).plan(2)
    plan = Server(get_smoke_config(arch), device="cpu", max_len=64).plan(2)
    warm = [-1, 0, 1, 2, 3]
    kw = dict(mode=mode, k_ahead=2, workers=4, dispatch=dispatch, warm_group_trace=warm)
    jws = JWeightStreamer(JHostParamStore(jparams, 1e6, 0.0), plan=jplan, **kw)
    ws = WeightStreamer(HostParamStore(params, 1e6, 0.0, device="cpu"), plan=plan, **kw)
    for s in (jws, ws):
        s.run_plan(compute_fn=_drain(s))
        s.close()
    assert ws.group_log == jws.group_log
    got = {k: getattr(ws.metrics, k) for k in _COUNTERS}
    want = {k: getattr(jws.metrics, k) for k in _COUNTERS}
    assert got == want
    assert got["fetches"] == len(plan.records) and got["bytes_moved"] == plan.total_bytes


def test_streamed_decode_equals_resident_decode():
    """A decode step whose weights the streamer serves group by group gives
    the resident step's logits and cache, bit for bit, in every mode; the
    resident step itself matches JAX's decode."""
    arch = "chatglm3_6b"
    cfg = get_smoke_config(arch).replace(compute_dtype="float32", attn_impl="pallas")
    jparams, params = _jax_params(arch)
    server = Server(cfg, device="cpu", max_len=64)
    inputs = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 32))
    logits, cache = server.prefill_fn(params, {"inputs": torch.from_numpy(inputs)})
    cache = server._pad_cache(cache)
    tok = torch.argmax(logits, dim=-1)
    resident = {k: v.clone() for k, v in cache.items()}
    want, _ = server.decode_fn(params, resident, tok, 32)

    jserver = JServer(jget_smoke(arch).replace(compute_dtype="float32", attn_impl="pallas"),
                      max_len=64)
    jtokens = np.array(jserver.generate(jparams, {"inputs": jnp.asarray(inputs, jnp.int32)}, 3))
    assert torch.equal(tok[:, 0], torch.from_numpy(jtokens[:, 0]).long())
    assert torch.equal(want.argmax(-1)[:, 0], torch.from_numpy(jtokens[:, 1]).long())

    plan = server.plan(2)
    store = HostParamStore(params, bandwidth_gbps=100.0, base_latency_s=0.0, device="cpu")
    for mode in (None, "rop", "capre", "markov", "hybrid"):
        ws = WeightStreamer(store, plan=plan, mode=mode, k_ahead=3, workers=8,
                            warm_group_trace=[-1, 0, 1, 2, 3])
        streamed = {k: v.clone() for k, v in cache.items()}
        got, _ = server.stream_decode(ws, streamed, tok, 32)
        ws.close()
        assert torch.equal(got, want), mode
        assert all(torch.equal(streamed[k], resident[k]) for k in cache)
        assert ws.metrics.fetches == len(plan.records) and ws.metrics.fetch_timeouts == 0


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "recurrentgemma_2b"])
def test_streamed_recurrent_decode_equals_resident_decode(arch):
    """The ssm and hybrid decode steps, streamed under each mode, give the
    resident step's logits and cache (conv and recurrent states, the
    hybrid's ring) bit for bit."""
    cfg = get_smoke_config(arch).replace(compute_dtype="float32", attn_impl="pallas")
    _, params = _jax_params(arch)
    server = Server(cfg, device="cpu", max_len=24)
    inputs = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 16))
    logits, cache = server.prefill_fn(params, {"inputs": torch.from_numpy(inputs)})
    cache = server._pad_cache(cache)
    tok = torch.argmax(logits, dim=-1)
    resident = {k: v.clone() for k, v in cache.items()}
    want, _ = server.decode_fn(params, resident, tok, 16)
    plan = server.plan(2)
    store = HostParamStore(params, bandwidth_gbps=100.0, base_latency_s=0.0, device="cpu")
    for mode in (None, "rop", "capre", "markov", "hybrid"):
        ws = WeightStreamer(store, plan=plan, mode=mode, k_ahead=3, workers=8,
                            warm_group_trace=list(range(-1, len(plan.groups()))))
        streamed = {k: v.clone() for k, v in cache.items()}
        got, _ = server.stream_decode(ws, streamed, tok, 16)
        ws.close()
        assert torch.equal(got, want), mode
        assert all(torch.equal(streamed[k], resident[k]) for k in cache), mode
        assert ws.metrics.fetches == len(plan.records) and ws.metrics.fetch_timeouts == 0


def test_stream_decode_raises_when_the_plan_misses_a_parameter():
    cfg = get_smoke_config("chatglm3_6b")
    server = Server(cfg, device="cpu", max_len=32)
    _, params = _jax_params("chatglm3_6b")
    partial = PrefetchPlan(records=[r for r in server.plan(1).records if r.path != "lm_head"])
    cache = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in server.model.abstract_cache(1, 32).items()}
    store = HostParamStore(params, 100.0, 0.0, device="cpu")
    ws = WeightStreamer(store, plan=partial, mode="capre")
    tok = concrete_batch(cfg, 1, 1, device="cpu")["inputs"]
    with pytest.raises(RuntimeError, match="lm_head"):
        server.stream_decode(ws, cache, tok, 0)
    ws.close()
