"""Plan-driven weight streaming — CAPre's prefetch executor on the tensor
store (DESIGN.md section 2).  Counterpart of ``repro.runtime.prefetch``.

The "persistent object store" here is host memory holding offloaded
parameters; the "application" is a layer-by-layer step execution.  Like the
paper's injected prefetch methods:

  * a **background executor** walks the PrefetchPlan (derived statically by
    ``core.access_plan``) and issues host->device copies ``k_ahead`` groups
    ahead of the compute frontier — zero runtime monitoring;
  * **collections** (stacked layer weights) fan out over a parallel pool —
    the paper's parallelStream() over a distributed collection;
  * the **ROP baseline** only ever fetches the next ``depth`` directly
    referenced groups when a group is entered (schema-only, no plan), and
    never streams collections ahead.

On a CUDA device the fetch is a real copy from pinned host memory
(``HostParamStore(device="cuda")``); on the CPU the store models transfer
latency, as the JAX package's does, so the overlap accounting is real.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.access_plan import AccessRecord, PrefetchPlan
from repro_torch.models.common import tree_items

#: the process id the streamer's spans render under in a merged Perfetto
#: timeline (Data Services own pids 0..n-1; the streamer is its own
#: producer track — exporters label it via ``process_names``)
STREAM_PID = 9000


@dataclass
class StreamMetrics:
    fetches: int = 0
    prefetch_hits: int = 0
    stalls: int = 0
    stall_seconds: float = 0.0
    bytes_moved: int = 0
    wasted_bytes: int = 0  # prefetched but never used
    batch_dispatches: int = 0  # pool submissions made by batched group fetches
    dedup_suppressed: int = 0  # paths suppressed pre-submission (cached/in-flight)
    fetch_timeouts: int = 0  # in-flight waits that expired; served via sync fallback
    hedged_fetches: int = 0  # straggling in-flight waits raced by a sync fetch
    hedge_wins: int = 0  # hedged fetches that beat the straggling lane


class HostParamStore:
    """Host-memory parameter store, keyed by dotted path.

    ``device="cpu"`` is the JAX package's modeled mode: the leaves stay CPU
    tensors, and a fetch sleeps ``base_latency + nbytes / bandwidth``, then
    returns the tensor.

    ``device="cuda"`` copies every leaf once into one pinned host buffer
    (pinning that fails raises: nothing streams from pageable memory).  A
    fetch is then a real host->device copy, ``non_blocking`` on a CUDA
    stream owned by the calling thread (each pool lane has its own),
    followed by an event the thread waits on before it returns: a fetched
    tensor has landed on the device, as a JAX ``device_put`` has.
    ``bandwidth`` and ``base_latency`` are then only what the streamer's
    stall attribution (``_disk_s``) assumes.

    The store keeps at most ``COPY_STREAMS`` streams and hands them to
    threads in turn, so the pools of successive streamers (one per step)
    copy on the same streams: a fetched tensor is allocated on its copy
    stream, and the caching allocator reuses a block only on the stream it
    was allocated on, so fresh streams every step would allocate afresh."""

    ALIGN = 512  # bytes between leaves in the pinned buffer
    COPY_STREAMS = 8  # the streamer's default pool width

    def __init__(self, params: dict, bandwidth_gbps: float = 8.0,
                 base_latency_s: float = 200e-6, device="cuda"):
        self.device = resolve_device(device)
        self.bandwidth = bandwidth_gbps * 1e9
        self.base_latency = base_latency_s
        self._local = threading.local()
        self._streams: list = []
        self._turn = 0
        self._streams_lock = threading.Lock()
        leaves = list(tree_items(params))
        if self.device.type != "cuda":
            self.arrays = {p: v.detach().to("cpu") for p, v in leaves}
            self.pinned_bytes = 0
            return
        offsets, total = [], 0
        for _, v in leaves:
            offsets.append(total)
            total += -(-v.nbytes // self.ALIGN) * self.ALIGN
        buf = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        if not buf.is_pinned():
            raise RuntimeError("HostParamStore: the host buffer could not be pinned")
        self.arrays = {}
        for (path, v), off in zip(leaves, offsets):
            dst = buf[off : off + v.nbytes].view(v.dtype).view(v.shape)
            dst.copy_(v.detach())
            self.arrays[path] = dst
        self.pinned_bytes = total

    def _stream(self) -> torch.cuda.Stream:
        stream = getattr(self._local, "stream", None)
        if stream is None:
            with self._streams_lock:
                if len(self._streams) < self.COPY_STREAMS:
                    self._streams.append(torch.cuda.Stream(device=self.device))
                stream = self._streams[self._turn % len(self._streams)]
                self._turn += 1
            self._local.stream = stream
        return stream

    def fetch(self, path: str) -> torch.Tensor:
        host = self.arrays[path]
        if self.device.type != "cuda":
            time.sleep(self.base_latency + host.nbytes / self.bandwidth)
            return host
        stream = self._stream()
        with torch.cuda.stream(stream):
            out = host.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()  # releases the GIL: the other lanes copy meanwhile
        return out

    def nbytes(self, path: str) -> int:
        return self.arrays[path].nbytes


def _on_compute_stream(arr):
    """Mark a served CUDA tensor as in use on the compute thread's current
    stream: it was allocated on a lane's copy stream, and the caching
    allocator must not hand its memory out again after eviction while
    kernels queued on the compute stream still read it."""
    if isinstance(arr, torch.Tensor) and arr.is_cuda:
        arr.record_stream(torch.cuda.current_stream(arr.device))
    return arr


class WeightStreamer:
    """Streams parameter groups onto the device ahead of use.  It is the
    same on every device: the store decides what a fetch is.

    ``mode`` resolves through the ``repro_torch.predict`` registry to a
    ``StreamPolicy`` (None = fetch on demand, every use stalls):

      * "capre": follows the PrefetchPlan order, ``k_ahead`` groups ahead,
        collections fanned out on the parallel pool;
      * "rop":   when a group is entered, fetch the next ``rop_depth``
        groups in tree order (schema heuristic, plan-blind);
      * "markov-miner" / "hybrid": trace-mined group transitions — warm
        them with ``warm_group_trace`` (the ``group_log`` of a prior run).

    ``dispatch`` mirrors ``ObjectStore``'s A/B knob: ``"batch"`` (default)
    pipelines each plan group through at most ``workers`` strided lanes,
    ``"per-oid"`` submits one pool task per path (the legacy reference).
    Passing a ``repro_torch.obs.Registry`` adopts :class:`StreamMetrics` as a
    snapshot source and records every ``get`` wait into a
    ``stream_stall_s`` histogram (0.0 for prefetch hits).

    Passing a ``repro_torch.obs.Tracer`` records the same lifecycle spans the
    ObjectStore emits (predicted -> dispatched -> claimed -> loaded ->
    hit/partial/miss), with ``service=STREAM_PID`` so the streamer renders
    as its own producer track in a merged Perfetto timeline.  Give the
    streamer its OWN tracer — its path-derived ids share an oid space with
    nothing else.  ``path_ids`` maps path -> span oid for labeling.
    """

    def __init__(
        self,
        store: HostParamStore,
        plan: Optional[PrefetchPlan] = None,
        mode: Optional[str] = "capre",
        k_ahead: int = 2,
        rop_depth: int = 1,
        workers: int = 4,
        warm_group_trace: Optional[list] = None,
        dispatch: str = "batch",
        registry=None,
        tracer=None,
        fetch_timeout: float = 30.0,
        hedge_delay: float = 0.0,
    ):
        self.store = store
        self.plan = plan
        self.mode = mode
        self.k_ahead = k_ahead
        self.rop_depth = rop_depth
        self.dispatch = dispatch
        self.metrics = StreamMetrics()
        self._stall_hist = None
        if registry is not None:
            from dataclasses import asdict

            registry.register_source("stream", lambda: asdict(self.metrics))
            self._stall_hist = registry.histogram("stream_stall_s")
        self.tracer = tracer
        self.path_ids: dict[str, int] = {}
        self._cache: dict[str, torch.Tensor] = {}
        self._inflight: dict[str, threading.Event] = {}
        self._used: set[str] = set()  # paths actually served to compute
        self._lock = threading.Lock()
        self._workers = max(1, workers)
        self._pool = ThreadPoolExecutor(max_workers=self._workers,
                                        thread_name_prefix="stream")
        self.fetch_timeout = fetch_timeout
        # hedged fetches (0.0 = off): a get() waiting on an in-flight lane
        # gives it hedge_delay seconds, then races it with a synchronous
        # fetch and serves whichever copy lands first — the streaming
        # analogue of the ObjectStore's hedged demand reads
        self.hedge_delay = hedge_delay
        self._groups = self._group_order()
        self._done = False
        self.group_log: list[int] = []  # entered group indices (miner food)
        self._policy = None
        if mode is not None:
            from repro_torch import predict

            self._policy = predict.make_stream_policy(mode)
            if warm_group_trace:
                self._policy.warm(warm_group_trace)

    # -- grouping ------------------------------------------------------------

    def _group_order(self) -> list[list[AccessRecord]]:
        """Execution-ordered groups of records (one group per first_use
        cluster — for a layer-looped model: embed, layers, head...)."""
        return [] if self.plan is None else self.plan.groups()

    # -- fetch machinery --------------------------------------------------------

    def _span_id(self, path: str) -> int:
        """Stable int id for a path's lifecycle spans (PrefetchSpan keys on
        int oids; the streamer's ids are only unique within its own
        tracer)."""
        with self._lock:
            sid = self.path_ids.get(path)
            if sid is None:
                sid = len(self.path_ids)
                self.path_ids[path] = sid
            return sid

    def _disk_s(self, path: str) -> float:
        """Modeled transfer seconds for hidden/stall attribution."""
        base = getattr(self.store, "base_latency", 0.0)
        bw = getattr(self.store, "bandwidth", 0.0)
        try:
            nbytes = self.store.nbytes(path)
        except Exception:
            return base
        return base + (nbytes / bw if bw else 0.0)

    def _fetch_async(self, path: str) -> None:
        with self._lock:
            if path in self._cache or path in self._inflight:
                return
            ev = threading.Event()
            self._inflight[path] = ev

        def work():
            arr = self.store.fetch(path)
            with self._lock:
                self._cache[path] = arr
                self.metrics.fetches += 1
                self.metrics.bytes_moved += arr.nbytes
                self._inflight.pop(path, None)
            ev.set()

        self._pool.submit(work)

    def fetch_group(self, paths) -> None:
        """Batched prefetch of one plan group: dedupe every path against
        cache and in-flight fetches under ONE lock snapshot (the per-record
        fan-out paid a lock round trip and a pool submission per path), then
        pipeline the survivors through at most ``workers`` lanes — strided,
        so the earliest-needed records start first on every lane.  This is
        the streaming analogue of ``ObjectStore.prefetch_batch``.

        Under ``dispatch="per-oid"`` the same request instead pays one lock
        round trip and one pool submission per path — the reference arm of
        the dispatch A/B."""
        paths = list(paths)
        tr = self.tracer
        if tr is not None and paths:
            tr.predicted([self._span_id(p) for p in paths],
                         origin=f"stream:{self.mode}")
        if self.dispatch == "per-oid":
            for path in paths:
                with self._lock:
                    if path in self._cache or path in self._inflight:
                        self.metrics.dedup_suppressed += 1
                        suppressed = True
                    else:
                        self._inflight[path] = threading.Event()
                        self.metrics.batch_dispatches += 1
                        suppressed = False
                if suppressed:
                    if tr is not None:
                        tr.suppressed([self._span_id(path)], STREAM_PID)
                    continue
                if tr is not None:
                    # claiming = winning the in-flight dedupe, which just
                    # happened under the lock (unlike the ObjectStore there
                    # is no separate per-service claim step)
                    sid = self._span_id(path)
                    tr.dispatched([sid], STREAM_PID, tr.new_batch())
                    tr.claimed([sid], STREAM_PID)
                self._pool.submit(self._fetch_lane, [path])
            return
        todo: list[str] = []
        sup: list[str] = []
        with self._lock:
            for path in paths:
                if path in self._cache or path in self._inflight or path in todo:
                    self.metrics.dedup_suppressed += 1
                    sup.append(path)
                    continue
                self._inflight[path] = threading.Event()
                todo.append(path)
        if tr is not None and sup:
            tr.suppressed([self._span_id(p) for p in sup], STREAM_PID)
        if not todo:
            return
        if tr is not None:
            ids = [self._span_id(p) for p in todo]
            tr.dispatched(ids, STREAM_PID, tr.new_batch())
            # claiming = winning the in-flight dedupe above (no separate
            # per-service claim step in the streamer)
            tr.claimed(ids, STREAM_PID)
        lanes = max(1, min(self._workers, len(todo)))
        with self._lock:
            self.metrics.batch_dispatches += lanes
        for i in range(lanes):
            self._pool.submit(self._fetch_lane, todo[i::lanes], i)

    def _fetch_lane(self, paths: list[str], lane: int = 0) -> None:
        tr = self.tracer
        for i, path in enumerate(paths):
            sid = self._span_id(path) if tr is not None else -1
            queued = time.perf_counter()
            try:
                arr = self.store.fetch(path)
            except BaseException:
                # release EVERY remaining claim, not just the failing one —
                # a stranded in-flight entry would pin each later path's
                # get() on a dead event (they fall back to _fetch_async)
                with self._lock:
                    evs = [self._inflight.pop(p, None) for p in paths[i:]]
                for ev in evs:
                    if ev is not None:
                        ev.set()
                if tr is not None:
                    tr.dropped([self._span_id(p) for p in paths[i:]],
                               "stream-fetch-error")
                raise
            done = time.perf_counter()
            with self._lock:
                self._cache[path] = arr
                self.metrics.fetches += 1
                self.metrics.bytes_moved += arr.nbytes
                ev = self._inflight.pop(path, None)
            if tr is not None:
                # the pool lane is the slot: no separate slot wait here
                tr.loaded([sid], STREAM_PID, lane, queued, queued, done)
            if ev is not None:
                ev.set()

    def get(self, path: str) -> torch.Tensor:
        """Blocking access from the compute thread."""
        tr = self.tracer
        with self._lock:
            arr = self._cache.get(path)
            ev = self._inflight.get(path)
            self._used.add(path)
        if arr is not None:
            self.metrics.prefetch_hits += 1
            if self._stall_hist is not None:
                self._stall_hist.record(0.0)
            if tr is not None:
                tr.demand(self._span_id(path), STREAM_PID,
                          time.perf_counter(), 0.0, full_load=False,
                          disk_load_s=self._disk_s(path))
            return _on_compute_stream(arr)
        t0 = time.perf_counter()
        was_inflight = ev is not None
        if ev is None:
            self._fetch_async(path)
            with self._lock:
                ev = self._inflight.get(path)
        landed, hedge_arr = True, None
        if ev is not None:
            if was_inflight and self.hedge_delay > 0:
                # hedged fetch: give the straggling lane hedge_delay to
                # land, then race it synchronously — first copy serves
                landed = ev.wait(timeout=min(self.hedge_delay,
                                             self.fetch_timeout))
                if not landed:
                    with self._lock:
                        self.metrics.hedged_fetches += 1
                    hedge_arr = self.store.fetch(path)
                    landed = ev.is_set()
            else:
                landed = ev.wait(timeout=self.fetch_timeout)
        with self._lock:
            arr = self._cache.get(path)
            if arr is None and hedge_arr is not None:
                # the hedge beat the lane: land + serve its copy (the lane
                # will overwrite the cache entry later, idempotently)
                self.metrics.hedge_wins += 1
                self.metrics.fetches += 1
                self.metrics.bytes_moved += hedge_arr.nbytes
                self._cache[path] = arr = hedge_arr
                landed = True
        if not landed or arr is None:
            # The in-flight wait expired (or the fetch errored and released
            # its event without landing anything): the old code did
            # ``self._cache[path]`` here and turned a slow lane into a bare
            # KeyError after the timeout.  Serve the compute thread with a
            # synchronous fetch instead — correctness over latency — and
            # count the incident so a saturated pool is visible.
            arr = self.store.fetch(path)
            with self._lock:
                self._cache[path] = arr
                self.metrics.fetches += 1
                self.metrics.bytes_moved += arr.nbytes
                if not landed:
                    self.metrics.fetch_timeouts += 1
            was_inflight = False  # the demand path did the full load itself
        stall = time.perf_counter() - t0
        self.metrics.stalls += 1
        self.metrics.stall_seconds += stall
        if self._stall_hist is not None:
            self._stall_hist.record(stall)
        if tr is not None:
            tr.demand(self._span_id(path), STREAM_PID, t0, stall,
                      full_load=not was_inflight,
                      disk_load_s=self._disk_s(path))
        return _on_compute_stream(arr)

    # -- the injected scheduling points ------------------------------------------

    def on_group_start(self, group_index: int) -> None:
        """Called when the compute frontier enters group ``group_index`` —
        the analogue of the injected prefetch-method invocation.  Delegates
        to the registry-resolved stream policy."""
        self.group_log.append(group_index)
        if self._policy is not None:
            self._policy.on_group_start(self, group_index)

    def run_plan(self, compute_s_per_group: float = 0.0,
                 compute_fn: Optional[Callable[[int, dict], None]] = None) -> float:
        """Execute the plan end to end: for each group, prefetch-ahead fires,
        then the compute thread `get`s every record in the group (stalling
        on misses) and runs the group compute.  Returns wall seconds."""
        t0 = time.perf_counter()
        if self._policy is not None:
            self.on_group_start(-1)
        for gi, group in enumerate(self._groups):
            arrays = {}
            for rec in group:
                arrays[rec.path] = self.get(rec.path)
            self.on_group_start(gi)
            if compute_fn is not None:
                compute_fn(gi, arrays)
            elif compute_s_per_group:
                time.sleep(compute_s_per_group)
            self._evict_before(gi)
        wall = time.perf_counter() - t0
        with self._lock:
            for p, a in self._cache.items():
                if p not in self._used:
                    self.metrics.wasted_bytes += a.nbytes
        return wall

    def _evict_before(self, gi: int) -> None:
        """Free groups already consumed (bounded device memory).  An evicted
        array that was prefetched but never served to compute is waste —
        charged here, where it leaves the cache, so prefetched-then-evicted
        mistakes are not invisible to the accounting."""
        if gi < 1:
            return
        with self._lock:
            for rec in self._groups[gi - 1]:
                arr = self._cache.pop(rec.path, None)
                if arr is not None and rec.path not in self._used:
                    self.metrics.wasted_bytes += arr.nbytes
                # usage is per-residency: once evicted, a re-prefetch of the
                # same path must be served again to count as useful
                self._used.discard(rec.path)

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)
        if self.tracer is not None:
            # prefetched-but-never-demanded spans terminate as dropped so
            # the exported timeline passes the one-terminal-state invariant
            self.tracer.drop_active("stream-closed")
