"""The distributed object store: Data Services, object placement, caches and
the access cost accounting (paper section 6).

Semantics mirrored from dataClay:

  * objects never leave the store; execution is redirected to the Data
    Service holding the object ("dataClay does not send the objects to the
    client but rather executes the methods locally in the same Data Service
    where the object is stored");
  * each Data Service has a local memory cache over its disk; *prefetching
    loads the object where it is stored* — it removes the disk load from the
    application's critical path but not the execution redirection;
  * stored collections are automatically distributed among the available
    Data Services, which is what makes parallel prefetching profitable —
    *how* they distribute is a pluggable placement policy (``pos.placement``:
    round-robin, consistent-hash, locality-aware subtree co-location);
  * objects may be stored on ``replication`` Data Services (primary +
    ring successors); demand reads pick a replica with load-aware routing
    (prefer the replica that already holds the line, else least-queued),
    and a crashed service fails over to the survivors: demand reads
    re-route, claimed-but-unlanded prefetch batches re-dispatch.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional

from .eviction import DEFAULT_POLICY, SharedBudget, make_policy
from .latency import LatencyModel, ZERO
from .placement import DEFAULT_PLACEMENT, make_placement
from .placement import spread as placement_spread
from .trace import TraceEvent, access_event, write_event, method_entry_event


class ServiceCrashed(RuntimeError):
    """An operation landed on a crashed Data Service.  The store's demand
    path catches this, marks the service down and fails over to a replica;
    batch lanes catch it and re-dispatch their unlanded oids."""

    def __init__(self, ds_id: int):
        super().__init__(f"data service {ds_id} crashed")
        self.ds_id = ds_id


class NoReplicaAvailable(RuntimeError):
    """Every replica of an object is down — with replication factor 1 a
    single crash makes its objects unreachable (the failure replication
    exists to mask)."""

    def __init__(self, oid: int, replicas):
        super().__init__(
            f"no alive replica for oid {oid} (replicas {list(replicas)})"
        )
        self.oid = oid


class RetryExhausted(RuntimeError):
    """The demand-path failover loop gave up after its bounded retries —
    every routing attempt kept landing on dead/unreachable services.  A
    full-outage oid now fails fast instead of spinning forever."""

    def __init__(self, oid: int, attempts: int):
        super().__init__(
            f"demand load of oid {oid} exhausted {attempts} failover retries"
        )
        self.oid = oid
        self.attempts = attempts


class QuorumUnreachable(RuntimeError):
    """A replicated write could not reach its W-of-R quorum (too many
    replicas dead or across a partition) within the bounded retry budget.
    The local update stands — the write degrades to sloppy — but the caller
    is told consistency was not achieved."""

    def __init__(self, oid: int, wanted: int, got: int):
        super().__init__(
            f"write quorum for oid {oid}: wanted {wanted} replicas, "
            f"only {got} reachable"
        )
        self.oid = oid
        self.wanted = wanted
        self.got = got


@dataclass
class PersistentObject:
    oid: int
    cls: str
    fields: dict[str, Any] = field(default_factory=dict)  # refs: oid / [oid]; prims: value


class _SlotRelease:
    """Context manager releasing an already-acquired semaphore slot."""

    def __init__(self, sem: threading.Semaphore):
        self._sem = sem

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._sem.release()
        return False


class DataService:
    def __init__(self, ds_id: int, latency: LatencyModel, cache_capacity: int = 0,
                 policy: str = DEFAULT_POLICY, budget: Optional[SharedBudget] = None):
        self.ds_id = ds_id
        self.latency = latency
        # fail-stop flag: crash() clears it; a dead service raises
        # ServiceCrashed from every load/claim so callers fail over
        self.alive = True
        self.disk: dict[int, PersistentObject] = {}
        # bounded memory cache (capacity 0 = unbounded, the paper's regime);
        # eviction order is delegated to a pluggable policy (pos.eviction) —
        # a bounded cache exposes prefetch thrashing: useless ROP prefetches
        # evict objects the application still needs.  Under a SharedBudget
        # every service draws lines from one global capacity instead, the
        # budget's policy spans all services (victims may be stolen from
        # another service's cache), and all services share one cache lock so
        # cross-service victim selection is race-free.
        self.cache_capacity = cache_capacity
        self.cache: dict[int, None] = {}
        self.budget = budget
        self.policy = budget.policy if budget is not None else make_policy(
            policy, capacity=cache_capacity
        )
        self._cache_lock = budget.lock if budget is not None else threading.Lock()
        self._slots = threading.Semaphore(max(1, latency.parallel_per_ds))
        # application threads queued for a disk slot: background prefetch
        # yields to them (see _yield_to_demand) — a hot batch lane
        # re-acquiring the slot semaphore would otherwise starve a woken
        # demand waiter indefinitely (semaphores are not FIFO-fair)
        self._demand_waiting = 0
        self._demand_clear = threading.Event()
        self._demand_clear.set()
        # request coalescing: concurrent loads of the same object share one
        # disk read — the second requester waits out the remaining latency
        self._inflight: dict[int, threading.Event] = {}
        # write-back cache state: updated-in-memory objects whose disk copy
        # is stale; flushed (paying ``latency.write_back``) on eviction and
        # on ``drop_cache``, never on the write itself
        self.dirty: set[int] = set()
        self.evictions = 0
        self.dirty_evictions = 0
        self.flushed_writes = 0
        # per-service prefetch counters (updated under this service's cache
        # lock) — the prefetch path used to charge the store-wide metrics
        # lock per oid, contending with the application thread; now each
        # service counts locally and ``ObjectStore.snapshot_metrics``
        # aggregates on read
        self.prefetch_requests = 0  # oids prefetch looked at (incl. cache hits)
        self.prefetch_loads = 0  # disk loads performed by prefetch work
        self.batch_dispatches = 0  # prefetch tasks submitted for this service
        self.dedup_suppressed = 0  # oids suppressed pre-submission (cached/in-flight/dup)
        self.demand_steals = 0  # lane-claimed oids a demand access took over
        self.rfo_prefetches = 0  # prefetch loads dirty-allocated (read-for-ownership)
        # set by the owning ObjectStore so flush/eviction events land on
        # the shared StoreMetrics too (None for a standalone DataService)
        self._owner: Optional["ObjectStore"] = None

    @property
    def _tracer(self):
        """The owning store's span tracer, if observability is attached
        (None otherwise — a standalone DataService records no spans).  The
        tracer's lock is a leaf, so calls are safe under the cache lock."""
        owner = self._owner
        obs = owner.obs if owner is not None else None
        return obs.tracer if obs is not None else None

    def _touch(self, oid: int, prefetch: bool = False) -> list[tuple["DataService", int]]:
        """Policy bump/insert + bounded-capacity eviction (callers hold the
        cache lock).  Returns the dirty ``(service, victim)`` pairs that now
        need flushing — the caller flushes *after* releasing the lock, on
        the victim's own service (which, under a shared budget, may not be
        this one)."""
        if oid in self.cache:
            self.policy.note_access(oid, prefetch=prefetch)
        else:
            self.cache[oid] = None
            if self.budget is not None:
                self.budget.note_insert(oid, self, prefetch=prefetch)
            else:
                self.policy.note_insert(oid, prefetch=prefetch)
        flushes: list[tuple[DataService, int]] = []
        if self.budget is not None:
            while self.budget.overflowed():
                holders, victim = self.budget.pick_victim()
                for vds in holders:  # every replica copy shares the line
                    vds._evict_line(victim, flushes)
        elif self.cache_capacity:
            while len(self.cache) > self.cache_capacity:
                self._evict_line(self.policy.pick_victim(), flushes)
        return flushes

    def _evict_line(self, victim: int, flushes: list[tuple["DataService", int]]) -> None:
        """Drop one resident line (policy already forgot it); queue its
        flush if dirty.  Callers hold the cache lock."""
        self.cache.pop(victim, None)
        self.evictions += 1
        tr = self._tracer
        if tr is not None:
            tr.evicted(victim)  # terminal "evicted" for an unused prefetch span
        if victim in self.dirty:
            self.dirty.discard(victim)
            self.dirty_evictions += 1
            if self._owner is not None:
                self._owner._note_dirty_eviction()
            flushes.append((self, victim))

    def _flush(self, oid: int) -> None:
        """Write a dirty object back to disk (occupies a disk slot for
        ``write_back`` seconds — the deferred cost of the write path).  On a
        crashed service the flush fails over to a live replica when one
        exists (replication > 1); otherwise the in-memory update is lost —
        counted, no longer silent."""
        if not self.alive:
            owner = self._owner
            if owner is not None and owner._flush_failover(self.ds_id, oid):
                return
            if owner is not None:
                owner._note_lost_write(self.ds_id, oid)
            return
        with self._slots:
            self.latency.sleep(self.latency.write_back_for(self.ds_id))
        self.flushed_writes += 1
        if self._owner is not None:
            self._owner._note_flush()

    def reset_counters(self) -> None:
        """Zero the per-service counters (between benchmark repetitions) —
        previously ``evictions`` survived ``reset_runtime_state`` and
        accumulated across reps, polluting every thrash-sweep row after
        the first."""
        self.evictions = 0
        self.dirty_evictions = 0
        self.flushed_writes = 0
        self.prefetch_requests = 0
        self.prefetch_loads = 0
        self.batch_dispatches = 0
        self.dedup_suppressed = 0
        self.demand_steals = 0
        self.rfo_prefetches = 0
        self.policy.protected_evictions = 0

    def is_cached(self, oid: int) -> bool:
        with self._cache_lock:
            return oid in self.cache

    def _yield_to_demand(self) -> None:
        """Background prefetch work parks until no application thread is
        waiting for one of this service's disk slots — the paper's contract
        ('the application thread is never interrupted') applied to the disk
        queue: demand loads have strict priority over prefetch loads.  The
        5s timeout is purely defensive (a stuck demand waiter must not hang
        the prefetcher forever)."""
        if self._demand_waiting:
            self._demand_clear.wait(5.0)

    def _demand_slot(self):
        """Acquire a disk slot for an application (demand) load, flagging
        the wait so background prefetch yields the queue.  Returns a
        context manager holding the slot."""
        with self._cache_lock:
            self._demand_waiting += 1
            self._demand_clear.clear()
        self._slots.acquire()
        with self._cache_lock:
            self._demand_waiting -= 1
            if self._demand_waiting == 0:
                self._demand_clear.set()
        return _SlotRelease(self._slots)

    def load_into_memory(self, oid: int, prefetch: bool = False,
                         rfo: bool = False) -> bool:
        """Disk -> memory. Returns True if this call performed the disk load
        (False: cached, or coalesced onto an in-flight load).  ``prefetch``
        marks the touch as prefetch-path for the eviction policy (a
        prefetch-aware policy must not count it as the application *using*
        the line).  ``rfo`` (prefetch only) dirty-allocates the line on
        landing — read-for-ownership for a statically-known update site, so
        the later write finds the line already owned.  Raises
        :class:`ServiceCrashed` on a dead service.

        Demand steal: if the oid is claimed by a batch lane that has not
        started loading it (``lane_pending`` on the in-flight event), a
        demand access takes the load over instead of waiting for the lane to
        reach it — the lane skips stolen oids when it finally gets a slot.
        The same event is reused, so coalesced waiters wake either way."""
        while True:
            flushes: list[tuple[DataService, int]] = []
            stole = False
            with self._cache_lock:
                if not self.alive:
                    raise ServiceCrashed(self.ds_id)
                if oid in self.cache:
                    flushes = self._touch(oid, prefetch=prefetch)
                    hit = True
                else:
                    hit = False
                    ev = self._inflight.get(oid)
                    if ev is None:
                        ev = threading.Event()
                        self._inflight[oid] = ev
                        owner = True
                    elif not prefetch and getattr(ev, "lane_pending", False):
                        ev.lane_pending = False
                        ev.stolen = True
                        self.demand_steals += 1
                        stole = True
                        owner = True
                    else:
                        owner = False
            if stole:
                tr = self._tracer
                if tr is not None:
                    tr.instant("demand-steal", service=self.ds_id, oid=oid)
            if hit:
                for vds, victim in flushes:
                    # flushing sleeps on a disk slot: never under the lock
                    vds._flush(victim)
                return False
            if owner:
                break
            ev.wait(timeout=5.0)
            # Re-check instead of assuming the load landed: the owner may
            # have timed out / been dropped (drop_cache wakes waiters with
            # nothing loaded).  A completed load still needs the LRU bump
            # this waiter's access deserves — both handled by looping back
            # to the cache check, which touches on hit and otherwise
            # performs (or re-coalesces onto) a fresh load.
            with self._cache_lock:
                if oid not in self.cache and self._inflight.get(oid) is ev and ev.is_set():
                    # the owner signalled but never landed the load: clear
                    # the stale entry so the next pass can take ownership
                    self._inflight.pop(oid, None)
        flushes = []
        try:
            if prefetch:
                # background load: let queued application loads go first
                self._yield_to_demand()
                slot = self._slots
            else:
                slot = self._demand_slot()
            with slot:
                if not self.alive:
                    raise ServiceCrashed(self.ds_id)
                self.latency.sleep(self.latency.disk_load_for(self.ds_id))
            with self._cache_lock:
                if not self.alive:
                    raise ServiceCrashed(self.ds_id)
                flushes = self._touch(oid, prefetch=prefetch)
                if rfo and prefetch:
                    self.dirty.add(oid)
                    self.rfo_prefetches += 1
        finally:
            with self._cache_lock:
                self._inflight.pop(oid, None)
            ev.set()
        for vds, victim in flushes:
            vds._flush(victim)
        self._beat()
        return True

    def _beat(self) -> None:
        """Heartbeat + per-load service-time sample for the fault detector
        (if the owning store has one attached): each landed load proves the
        service alive and feeds the straggler detector's timing baseline."""
        owner = self._owner
        if owner is not None and owner.fault is not None:
            owner.fault.beat(self.ds_id, self.latency.disk_load_for(self.ds_id))

    def crash(self) -> None:
        """Fail-stop this service: the memory cache and every in-flight
        load are lost (waiters wake and re-check — on a dead service the
        re-check raises, and the store's demand path fails over).  Disk
        contents are left in place: replicas on other services still share
        the same :class:`PersistentObject` records."""
        with self._cache_lock:
            self.alive = False
            for oid in self.cache:
                if self.budget is not None:
                    self.budget.note_remove(oid, self)
                else:
                    self.policy.note_remove(oid)
            self.cache.clear()
            for ev in self._inflight.values():
                ev.set()
            self._inflight.clear()
            self.dirty.clear()
            self._demand_waiting = 0
            self._demand_clear.set()

    def revive(self) -> None:
        """Bring a crashed service back to life with a COLD cache (crash
        already cleared it): loads and claims succeed again.  Routing
        readmission and anti-entropy resync are the owning store's job
        (``ObjectStore.revive_service``)."""
        with self._cache_lock:
            self.alive = True

    # -- batched prefetch dispatch ------------------------------------------

    def claim_prefetch_batch(self, oids: Iterable[int]) -> list[int]:
        """Dedupe a prefetch batch against cache and in-flight loads under
        ONE cache-lock acquisition (the per-oid path paid a lock round trip
        per object just to discover most of them were already resident).
        Already-cached oids get their policy bump (a prefetch touch, like
        the per-oid path's hit) and are suppressed; in-flight oids are
        suppressed outright (their load is coming).  Returns the oids still
        worth submitting, in request (= predicted-need) order.  Counters
        (``prefetch_requests`` / ``dedup_suppressed`` / ``batch_dispatches``)
        are charged here, under the same lock hold."""
        todo: list[int] = []
        claimed: set[int] = set()
        with self._cache_lock:
            if not self.alive:
                raise ServiceCrashed(self.ds_id)
            for oid in oids:
                self.prefetch_requests += 1
                if oid in claimed:
                    self.dedup_suppressed += 1  # duplicate within the batch
                elif oid in self.cache:
                    # resident: bump only (cannot overflow — no insert)
                    self.policy.note_access(oid, prefetch=True)
                    self.dedup_suppressed += 1
                elif oid in self._inflight:
                    self.dedup_suppressed += 1
                else:
                    claimed.add(oid)
                    todo.append(oid)
            if todo:
                self.batch_dispatches += 1
        return todo

    def load_batch(self, oids: Iterable[int], prefetch: bool = True,
                   pool=None, rfo: frozenset = frozenset()) -> None:
        """Load a batch of objects disk -> memory in request order,
        pipelining through this service's ``parallel_per_ds`` slots: with a
        pool, the batch splits into one lane per slot (strided, so the
        earliest-needed oids start first on every lane); without one, the
        calling worker drains the batch alone.  Unlike the per-oid path
        there is no per-object task submission and no store-wide
        metrics-lock traffic — landing a load costs one cache-lock
        acquisition (policy touch + in-flight clear together).  Oids in
        ``rfo`` dirty-allocate on landing (read-for-ownership)."""
        oids = list(oids)
        lanes = max(1, min(self.latency.parallel_per_ds, len(oids)))
        if pool is not None and lanes > 1:
            for i in range(1, lanes):
                pool.submit(self._load_lane, oids[i::lanes], prefetch, i, rfo)
            self._load_lane(oids[0::lanes], prefetch, 0, rfo)
        else:
            self._load_lane(oids, prefetch, rfo=rfo)

    #: loads claimed/slept/landed per lane iteration: one slot hold, one
    #: claim lock, one land lock per chunk (instead of per oid); bounds how
    #: long a demand access coalescing onto a claimed oid can wait
    _LANE_CHUNK = 4

    def _load_lane(self, oids: list[int], prefetch: bool, lane: int = 0,
                   rfo: frozenset = frozenset()) -> None:
        """One pipeline lane of a batched load: claim a chunk under one
        lock, occupy a disk arm for the chunk's sequential loads, land the
        chunk under one lock.  Oids that became resident (or in flight
        elsewhere) since the batch was deduped are skipped at claim time.
        With a tracer attached, each chunk records its slot wait vs disk
        service split (chunk-granular: the chunk shares one slot hold).

        Claimed-but-unstarted oids are *stealable*: a demand access for one
        of them flips the event's ``stolen`` flag and performs the load
        itself; this lane drops those from the chunk once it holds a slot
        (the event now belongs to the stealer).  If the service crashes
        mid-lane, every unlanded oid is handed back to the owning store for
        re-dispatch on a surviving replica."""
        tr = self._tracer
        pending = list(oids)
        while pending:
            if not self.alive:
                self._abort_lane(pending, rfo)
                return
            # the lane re-acquires the slot back-to-back; without this
            # yield a waiting demand load would lose every race for it
            self._yield_to_demand()
            chunk: list[tuple[int, threading.Event]] = []
            with self._cache_lock:
                while pending and len(chunk) < self._LANE_CHUNK:
                    oid = pending.pop(0)
                    if oid in self.cache:
                        # landed since the dispatch snapshot: bump, move on
                        self.policy.note_access(oid, prefetch=prefetch)
                    elif oid not in self._inflight:  # else: another loader owns it
                        ev = threading.Event()
                        ev.lane_pending = True  # steal window open
                        self._inflight[oid] = ev
                        chunk.append((oid, ev))
            if not chunk:
                continue
            t_q = time.perf_counter() if tr is not None else 0.0
            flushes: list[tuple[DataService, int]] = []
            try:
                with self._slots:
                    with self._cache_lock:
                        # steal handshake: demand took these over while the
                        # chunk queued for a slot — their events are now the
                        # stealers' to complete; load only the survivors
                        chunk = [(oid, ev) for oid, ev in chunk
                                 if not getattr(ev, "stolen", False)]
                        for _oid, ev in chunk:
                            ev.lane_pending = False
                        crashed = not self.alive
                    if crashed:
                        raise ServiceCrashed(self.ds_id)
                    if not chunk:
                        continue
                    t_s = time.perf_counter() if tr is not None else 0.0
                    # k sequential loads pipelined on one disk arm
                    self.latency.sleep(
                        self.latency.disk_load_for(self.ds_id) * len(chunk))
                    t_d = time.perf_counter() if tr is not None else 0.0
                with self._cache_lock:
                    if not self.alive:
                        raise ServiceCrashed(self.ds_id)
                    for oid, _ev in chunk:
                        flushes.extend(self._touch(oid, prefetch=prefetch))
                        self._inflight.pop(oid, None)
                        self.prefetch_loads += 1
                        if oid in rfo:
                            self.dirty.add(oid)
                            self.rfo_prefetches += 1
            except ServiceCrashed:
                with self._cache_lock:
                    for oid, _ev in chunk:
                        self._inflight.pop(oid, None)
                for _oid, ev in chunk:
                    ev.set()
                self._abort_lane([oid for oid, _ev in chunk] + pending, rfo)
                return
            except BaseException:
                with self._cache_lock:
                    for oid, _ev in chunk:
                        self._inflight.pop(oid, None)
                if tr is not None:
                    tr.dropped([oid for oid, _ev in chunk], "load-error")
                raise
            finally:
                for _oid, ev in chunk:
                    ev.set()
            if tr is not None:
                tr.loaded([oid for oid, _ev in chunk], self.ds_id, lane,
                          t_q, t_s, t_d)
            for vds, victim in flushes:
                vds._flush(victim)
            self._beat()

    def _abort_lane(self, oids: list[int], rfo: frozenset = frozenset()) -> None:
        """This service died mid-batch: hand every claimed-but-unlanded and
        still-pending oid back to the store, which re-dispatches them to a
        surviving replica (a no-op for a standalone service or when no
        replica is left — the demand path then eats the miss).  RFO marks
        survive the re-dispatch."""
        if not oids or self._owner is None:
            return
        self._owner._note_service_down(self.ds_id)
        self._owner._failover_redispatch(self.ds_id, oids, rfo=rfo)

    def write(self, oid: int) -> bool:
        """Write-allocate + write-back: ensure the object is in memory (a
        write to an uncached object performs the disk load and counts as a
        miss) and mark it dirty.  The ``write_back`` latency is deferred to
        eviction / ``drop_cache``, when the dirty line is flushed.  Returns
        True if this write performed the allocating disk load."""
        did_load = self.load_into_memory(oid)
        with self._cache_lock:
            if oid in self.cache:  # unless concurrently evicted already
                self.dirty.add(oid)
        return did_load

    def drop_cache(self) -> None:
        with self._cache_lock:
            for oid in self.cache:
                if self.budget is not None:
                    self.budget.note_remove(oid, self)
                else:
                    self.policy.note_remove(oid)
            self.cache.clear()
            for ev in self._inflight.values():
                ev.set()
            self._inflight.clear()
            dirty, self.dirty = self.dirty, set()
        for oid in dirty:
            self._flush(oid)


def prefetch_accuracy(prefetched: set, accessed: set) -> dict:
    """Set-based precision/recall of a prefetcher — shared between the live
    store accounting and the offline trace-replay harness
    (``predict.evaluate``), so both report identical definitions.

    A predictor that emitted nothing has *no* precision, not a precision of
    0.0 — the two used to be indistinguishable and recorded phantom zeros in
    comparison tables.  Undefined ratios are now ``None`` (rendered NaN-safe
    by consumers) and ``evaluated`` says whether any prefetch happened at
    all."""
    tp = len(prefetched & accessed)
    fp = len(prefetched - accessed)
    fn = len(accessed - prefetched)
    return {
        "true_positives": tp,
        "false_positives": fp,
        "false_negatives": fn,
        "precision": tp / (tp + fp) if tp + fp else None,
        "recall": tp / (tp + fn) if tp + fn else None,
        "evaluated": bool(prefetched),
    }


#: the prefetch-path counters that live on each DataService (the prefetch
#: path no longer touches the store-wide metrics lock); aggregated across
#: services by ``ObjectStore.snapshot_metrics``
PREFETCH_COUNTERS = (
    "prefetch_requests",
    "prefetch_loads",
    "batch_dispatches",
    "dedup_suppressed",
    "demand_steals",
    "rfo_prefetches",
)


@dataclass
class StoreMetrics:
    """Application-path counters (guarded by the store's metrics lock).
    Prefetch-path counters are per-service (``PREFETCH_COUNTERS``) so the
    background prefetch threads never contend with the application thread
    on this lock — read them via ``ObjectStore.snapshot_metrics``."""

    app_loads: int = 0
    app_cache_hits: int = 0
    app_cache_misses: int = 0
    remote_hops: int = 0
    writes: int = 0
    write_hits: int = 0  # writes that found the object already in memory
    dirty_evictions: int = 0  # evictions that had to flush a dirty object
    flushed_writes: int = 0  # write-backs actually performed (evict + drop)
    failovers: int = 0  # demand retries / batch re-dispatches off a dead service
    services_crashed: int = 0  # crash_service invocations (fault injection)
    stragglers_flagged: int = 0  # services the straggler detector deprioritized
    lost_writes: int = 0  # dirty flushes dropped on a dead service, no replica
    failover_retries: int = 0  # demand failover attempts beyond the first
    partitions: int = 0  # partition() invocations (fault injection)
    readmissions: int = 0  # services readmitted to routing (heal / revive)
    resync_lines: int = 0  # dirty lines anti-entropy replayed at readmission
    hedged_reads: int = 0  # demand reads that issued a second-replica hedge
    hedge_wins: int = 0  # hedged reads where the second replica answered first
    quorum_writes: int = 0  # replicated writes that reached their W-of-R quorum
    quorum_acks: int = 0  # synchronous replica acks charged (W-1 per write)
    quorum_retries: int = 0  # quorum attempts that backed off and retried
    quorum_failures: int = 0  # writes whose quorum stayed unreachable (sloppy)

    def snapshot(self) -> dict[str, int]:
        return dict(self.__dict__)


class ExecutionContext:
    """Tracks where the current application thread is executing (which Data
    Service) so navigation costs can charge execution redirection.

    Multi-tenant attribution rides here too: ``session_label`` stamps the
    demand spans this thread opens (per-call, never via shared tracer
    state), and ``stall_hist`` — a pre-resolved per-tenant histogram — gets
    every demand stall in addition to the per-service one."""

    def __init__(self, store: "ObjectStore", session_label: str = "",
                 stall_hist=None):
        self.store = store
        self.current_ds: Optional[int] = None
        self.session_label = session_label
        self.stall_hist = stall_hist


class ObjectStore:
    """The POS: N Data Services + placement + cost accounting."""

    def __init__(self, n_services: int = 4, latency: LatencyModel = ZERO,
                 cache_capacity: int = 0, cache_policy: str = DEFAULT_POLICY,
                 shared_budget: bool = False,
                 placement: str = DEFAULT_PLACEMENT, replication: int = 1,
                 write_quorum: int = 1, hedge: bool = False,
                 hedge_delay: Optional[float] = None):
        self.latency = latency
        self.cache_policy = cache_policy
        # shared-memory-budget mode: ``cache_capacity`` is one global line
        # budget all services draw from (policy-mediated stealing), instead
        # of a fixed per-service capacity
        self.budget = (
            SharedBudget(cache_capacity, policy=cache_policy)
            if shared_budget and cache_capacity
            else None
        )
        self.services = [
            DataService(i, latency,
                        0 if self.budget is not None else cache_capacity,
                        policy=cache_policy, budget=self.budget)
            for i in range(n_services)
        ]
        for ds in self.services:
            ds._owner = self
        # placement is a policy (pos.placement), the way eviction is: the
        # policy returns each new object's replica set (primary first)
        self.placement_name = placement
        self.replication = max(1, min(replication, n_services))
        self._placer = make_placement(placement, n_services, self.replication)
        self._placement: dict[int, tuple[int, ...]] = {}  # oid -> replica set
        # creation log (oid, cls, group, pinned_ds) — enough to re-place the
        # whole store under a different policy (rebuild_placement) and to
        # snapshot/restore placement inputs for the trace cache
        self._put_log: list[tuple[int, str, Optional[str], Optional[int]]] = []
        # failure bookkeeping: services routing must avoid (detected dead)
        # and deprioritize (detector-flagged stragglers).  A crashed-but-
        # unannounced service stays routable until the error path or the
        # heartbeat monitor catches it — that window IS the failure model.
        self._down: set[int] = set()
        self._slow: set[int] = set()
        # network partition ground truth: services currently unreachable
        # from the client-side group (partition()/heal_partition()) —
        # distinct from _down, which is *detected* state.  Traffic routed
        # to a cut service fails exactly like a crash.
        self._net_cut: set[int] = set()
        # anti-entropy write log: replica -> oids whose writes it missed
        # while dead/partitioned; resynced (flushed on the replica) at
        # readmission.  Guarded by the metrics lock (writes hold it anyway).
        self._missed_writes: dict[int, set[int]] = {}
        # per-tenant failover attribution (session label -> count), for the
        # multi-tenant harness; guarded by the metrics lock
        self.failovers_by_session: dict[str, int] = {}
        # write quorum: replicated writes wait for W-of-R synchronous
        # replica acks (1 = async/sloppy, the legacy behavior)
        self.write_quorum = max(1, min(write_quorum, self.replication))
        # hedged reads: demand misses issue to a second replica after
        # hedge_delay and take the first response (None = derive the delay
        # from observed p99 stall, fallback 3x disk_load)
        self.hedge = hedge
        self.hedge_delay = hedge_delay
        self.fault = None  # optional runtime.fault.StoreFaultDetector
        self._oid_counter = itertools.count(1)
        self._metrics_lock = threading.Lock()
        self.metrics = StoreMetrics()
        # accuracy accounting (true/false positives of prefetching) — the
        # prefetched set has its own lock so prefetch threads recording
        # their work never block the application thread's metrics updates
        self._prefetch_lock = threading.Lock()
        self.accessed_oids: set[int] = set()
        self.prefetched_oids: set[int] = set()
        # live PrefetchRuntimes attached by Sessions: reset_runtime_state
        # drains them so straggler prefetch tasks from one benchmark
        # repetition cannot leak work into the next
        self._runtimes: set = set()
        # set to [] to record the application's event stream as schema-v2
        # TraceEvent records (access / write / method_entry — pos.trace)
        self.trace: Optional[list[TraceEvent]] = None
        # optional callback fired on every application-path cache miss —
        # how the ROP baseline hooks its eager referenced-object fetch
        self.miss_listener = None
        # optional callback fired on EVERY application-path access (hit or
        # miss) — the monitoring hook the trace-mined predictors pay for
        self.access_listener = None
        # observability context (repro_torch.obs.Observability): attach_obs wires
        # the metrics registry + optional span tracer; None = uninstrumented
        # (the hot paths then skip every obs branch)
        self.obs = None
        self._stall_hists: Optional[dict[int, Any]] = None

    def attach_obs(self, obs) -> None:
        """Attach an ``Observability`` context: registers this store's
        metrics as a registry source and pre-resolves the per-service demand
        stall histograms so the application path never hits the registry's
        lookup lock.  Span tracing activates iff ``obs.tracer`` is set."""
        self.obs = obs
        obs.registry.register_source("store", self.snapshot_metrics)
        self._stall_hists = {
            ds.ds_id: obs.registry.histogram("demand_stall_s", service=ds.ds_id)
            for ds in self.services
        }

    # -- placement ---------------------------------------------------------

    def new_oid(self) -> int:
        return next(self._oid_counter)

    def put(self, cls: str, fields: Optional[dict[str, Any]] = None,
            ds: Optional[int] = None, group: Optional[str] = None) -> int:
        """Store a new object; the placement policy picks its replica set
        (primary first) unless pinned to ``ds``.  ``group`` is the locality
        hint — apps tag a collection element's whole subtree with one key so
        the locality policy co-locates it (other policies ignore it).  With
        ``replication > 1`` the same record lands on R services: one
        :class:`PersistentObject` instance shared by all replica disks, so
        field state is trivially consistent (this is a latency/availability
        model, not a durability protocol).  Pinned puts do not advance the
        policy — the legacy contract that keeps pinning side-effect-free."""
        oid = self.new_oid()
        if ds is None:
            reps = self._placer.place(oid, cls, group=group)
        else:
            reps = placement_spread(ds, len(self.services), self.replication)
        obj = PersistentObject(oid=oid, cls=cls, fields=fields or {})
        for r in reps:
            self.services[r].disk[oid] = obj
        self._placement[oid] = reps
        self._put_log.append((oid, cls, group, ds))
        return oid

    def service_of(self, oid: int) -> DataService:
        """The object's *primary* Data Service (replica set's first entry —
        what the virtual-clock replay and placement-agnostic callers use)."""
        return self.services[self._placement[oid][0]]

    def replicas_of(self, oid: int) -> tuple[int, ...]:
        return self._placement[oid]

    def record(self, oid: int) -> PersistentObject:
        # any replica works (shared instance); read the primary's disk
        return self.service_of(oid).disk[oid]

    def cls_of(self, oid: int) -> str:
        return self.record(oid).cls

    def rebuild_placement(self, placement: str, replication: int = 1) -> None:
        """Re-place every stored object under a different policy and/or
        replication factor without re-recording anything: replay the
        creation log (same order, same group hints, pins respected) through
        a fresh policy instance.  Determinism of the policies guarantees the
        result is identical to having created the store this way.  Caches
        must be cold (use between replays, not mid-run)."""
        n = len(self.services)
        records = {oid: self.record(oid) for oid, _cls, _grp, _pin in self._put_log}
        self.placement_name = placement
        self.replication = max(1, min(replication, n))
        self._placer = make_placement(placement, n, self.replication)
        self._placement.clear()
        for svc in self.services:
            svc.disk.clear()
        for oid, cls, group, pin in self._put_log:
            if pin is None:
                reps = self._placer.place(oid, cls, group=group)
            else:
                reps = placement_spread(pin, n, self.replication)
            self._placement[oid] = reps
            for r in reps:
                self.services[r].disk[oid] = records[oid]

    # -- replica routing -----------------------------------------------------

    def _pick_replica(self, oid: int, alive: list[int],
                      reps: tuple[int, ...]) -> DataService:
        """Load-aware replica choice: prefer a replica that already holds
        (or is loading) the line — prefetch landed it there — else the
        least-queued non-straggler; ties break in replica order, primary
        first.  The racy cache/inflight peeks are deliberate (routing is a
        hint; correctness lives in load_into_memory)."""
        for i in alive:
            ds = self.services[i]
            if oid in ds.cache or oid in ds._inflight:
                return ds
        return self.services[min(
            alive,
            key=lambda i: (i in self._slow,
                           self.services[i]._demand_waiting
                           + len(self.services[i]._inflight),
                           reps.index(i)),
        )]

    def _route_demand(self, oid: int) -> DataService:
        """Pick the replica a demand access should execute on.  Routing
        consults *detected* state only (``_down``): a crashed service that
        nobody has noticed yet still gets traffic — the resulting
        :class:`ServiceCrashed` is how the error path detects it."""
        reps = self._placement[oid]
        if len(reps) == 1:  # replication 1: byte-identical legacy routing
            if reps[0] in self._down:
                raise NoReplicaAvailable(oid, reps)
            return self.services[reps[0]]
        alive = [i for i in reps if i not in self._down]
        if not alive:
            raise NoReplicaAvailable(oid, reps)
        if len(alive) == 1:
            return self.services[alive[0]]
        return self._pick_replica(oid, alive, reps)

    def _route_prefetch(self, oid: int) -> Optional[DataService]:
        """Like ``_route_demand`` but a prefetch with no reachable replica
        is silently skipped (None) — the demand path will surface the
        failure if the object is ever actually needed."""
        reps = self._placement[oid]
        if len(reps) == 1:
            return None if reps[0] in self._down else self.services[reps[0]]
        alive = [i for i in reps if i not in self._down]
        if not alive:
            return None
        if len(alive) == 1:
            return self.services[alive[0]]
        return self._pick_replica(oid, alive, reps)

    # -- application-path access -------------------------------------------

    def _redirect(self, ctx: Optional[ExecutionContext], ds: DataService) -> None:
        """Charge execution redirection if the application thread is not
        already on the owning Data Service."""
        if ctx is not None and ctx.current_ds != ds.ds_id:
            self.latency.sleep(self.latency.remote_hop)
            ctx.current_ds = ds.ds_id
            with self._metrics_lock:
                self.metrics.remote_hops += 1

    def _notify(self, oid: int, did_load: bool) -> None:
        """Fire the demand-path listeners (shared by reads and writes, so
        the monitoring family observes the full get/put stream)."""
        if did_load and self.miss_listener is not None:
            self.miss_listener(oid)
        if self.access_listener is not None:
            self.access_listener(oid)

    #: bounded demand-path failover budget: a full-outage oid fails fast
    #: (RetryExhausted) instead of spinning on routing that keeps landing
    #: on corpses; each retry backs off exponentially on failover_detect
    MAX_FAILOVER_RETRIES = 4

    def _demand_load(self, ctx: Optional[ExecutionContext], oid: int,
                     write: bool = False) -> tuple[DataService, bool]:
        """Demand access with failover: route to a replica, redirect
        execution, load (or write-allocate).  A :class:`ServiceCrashed`
        marks the service down, charges ``failover_detect`` (exponentially
        backed off per retry), and retries on a surviving replica —
        :class:`NoReplicaAvailable` escapes when none is left, and
        :class:`RetryExhausted` after ``MAX_FAILOVER_RETRIES`` failed
        attempts.  A service across a network partition fails exactly like
        a crashed one.  With hedging armed, a read that outlives the hedge
        delay issues to a second replica and takes the first response.  The
        stall histogram/span covers the WHOLE wait including failed
        attempts (that is what the application thread experienced)."""
        obs = self.obs
        t0 = time.perf_counter() if obs is not None else 0.0
        attempts = 0
        while True:
            ds = self._route_demand(oid)
            self._redirect(ctx, ds)
            try:
                if ds.ds_id in self._net_cut:
                    raise ServiceCrashed(ds.ds_id)
                if self.hedge and not write:
                    did_load, ds = self._hedged_load(oid, ds)
                else:
                    did_load = ds.write(oid) if write else ds.load_into_memory(oid)
                break
            except ServiceCrashed as exc:
                attempts += 1
                self._note_service_down(exc.ds_id)
                label = ctx.session_label if ctx is not None else ""
                with self._metrics_lock:
                    self.metrics.failovers += 1
                    if attempts > 1:
                        self.metrics.failover_retries += 1
                    self.failovers_by_session[label] = (
                        self.failovers_by_session.get(label, 0) + 1)
                tr = obs.tracer if obs is not None else None
                if tr is not None:
                    tr.instant("demand-failover", service=exc.ds_id, oid=oid)
                if attempts > self.MAX_FAILOVER_RETRIES:
                    raise RetryExhausted(oid, attempts) from exc
                self.latency.sleep(
                    self.latency.failover_detect * (2 ** (attempts - 1)))
        if obs is not None:
            stall = time.perf_counter() - t0
            self._stall_hists[ds.ds_id].record(stall)
            if ctx is not None and ctx.stall_hist is not None:
                ctx.stall_hist.record(stall)
            if obs.tracer is not None:
                obs.tracer.demand(oid, ds.ds_id, t0, stall, did_load,
                                  self.latency.disk_load_for(ds.ds_id),
                                  session=ctx.session_label if ctx is not None
                                  else "")
        if self.fault is not None:
            self.fault.tick()
        return ds, did_load

    # -- hedged reads --------------------------------------------------------

    def _hedge_delay_for(self, ds_id: int) -> float:
        """The wait before a hedge fires: an explicit ``hedge_delay`` wins;
        else the observed p99 demand stall on the primary service (needs
        >= 32 samples so early noise cannot arm hair-trigger hedges); else
        3x the nominal disk load — roughly where a queued-or-degraded load
        separates from a healthy one."""
        if self.hedge_delay is not None:
            return self.hedge_delay
        if self._stall_hists is not None:
            hist = self._stall_hists.get(ds_id)
            if hist is not None and hist.count >= 32:
                (p99,) = hist.percentiles((0.99,))
                if p99:
                    return p99
        return 3 * self.latency.disk_load

    def _hedge_alt(self, oid: int, primary: DataService) -> Optional[DataService]:
        """The second replica a hedged read would issue to: any reachable
        replica other than the primary, least-queued first."""
        reps = self._placement[oid]
        alts = [i for i in reps
                if i != primary.ds_id and i not in self._down
                and i not in self._net_cut and self.services[i].alive]
        if not alts:
            return None
        return self.services[min(
            alts,
            key=lambda i: (self.services[i]._demand_waiting
                           + len(self.services[i]._inflight),
                           reps.index(i)),
        )]

    def _hedged_load(self, oid: int,
                     primary: DataService) -> tuple[bool, DataService]:
        """Speculative-read demand load: issue to ``primary``; if it has not
        answered within the hedge delay, issue the same load to a second
        replica and take whichever answers first (both loads run to
        completion — the loser's disk time is the price of the tail cut).
        Returns ``(did_load, winning_service)``.  With no second replica
        available this degrades to a plain load."""
        alt = self._hedge_alt(oid, primary)
        if alt is None:
            return primary.load_into_memory(oid), primary
        outcome: dict[str, Any] = {}
        done = threading.Event()
        lock = threading.Lock()

        def _primary() -> None:
            try:
                dl = primary.load_into_memory(oid)
                with lock:
                    outcome.setdefault("win", (primary, dl))
            except BaseException as exc:  # surfaced if the hedge loses too
                with lock:
                    outcome.setdefault("primary_error", exc)
            done.set()

        th = threading.Thread(target=_primary, daemon=True,
                              name=f"hedge-primary-{primary.ds_id}")
        th.start()
        if done.wait(self._hedge_delay_for(primary.ds_id)):
            with lock:
                if "win" in outcome:
                    ds, dl = outcome["win"]
                    return dl, ds
            # primary failed fast: the hedge below is also the failover
        with self._metrics_lock:
            self.metrics.hedged_reads += 1
        tr = self.obs.tracer if self.obs is not None else None
        if tr is not None:
            tr.instant("hedged-read", service=alt.ds_id, oid=oid)
        try:
            dl = alt.load_into_memory(oid)
        except BaseException:
            done.wait(5.0)
            with lock:
                if "win" in outcome:
                    ds, dl = outcome["win"]
                    return dl, ds
            raise
        with lock:
            outcome.setdefault("win", (alt, dl))
            ds, dl = outcome["win"]
        if ds is alt:
            with self._metrics_lock:
                self.metrics.hedge_wins += 1
        return dl, ds

    # -- write quorum --------------------------------------------------------

    #: bounded quorum wait: attempts before a replicated write gives up on
    #: its W-of-R quorum and degrades to sloppy (QuorumUnreachable)
    MAX_QUORUM_RETRIES = 4

    def _await_write_quorum(self, oid: int, ds: DataService) -> None:
        """Synchronous W-of-R replication for a write: wait until at least
        ``write_quorum`` replicas are reachable (ground truth — acks need
        live services, not routing guesses), charge one ``remote_hop`` per
        extra ack, and propagate the dirty bit to the acking replicas'
        resident lines.  Unreachable quorums retry with exponential backoff
        (a healing partition can unblock a waiter), then surface as
        :class:`QuorumUnreachable` — the local write stands (sloppy), the
        caller learns consistency was not achieved."""
        reps = self._placement[oid]
        want = min(self.write_quorum, len(reps))
        if want <= 1:
            return
        backoff = max(self.latency.failover_detect, self.latency.disk_load)
        reachable: list[int] = []
        for attempt in range(self.MAX_QUORUM_RETRIES + 1):
            reachable = [r for r in reps
                         if self.services[r].alive and r not in self._net_cut]
            if len(reachable) >= want:
                acks = want - 1
                for _ in range(acks):
                    self.latency.sleep(self.latency.remote_hop)
                for r in reachable:
                    if r == ds.ds_id:
                        continue
                    svc = self.services[r]
                    with svc._cache_lock:
                        if oid in svc.cache:
                            svc.dirty.add(oid)
                with self._metrics_lock:
                    self.metrics.quorum_writes += 1
                    self.metrics.quorum_acks += acks
                return
            if attempt == self.MAX_QUORUM_RETRIES:
                break
            with self._metrics_lock:
                self.metrics.quorum_retries += 1
            self.latency.sleep(backoff * (2 ** attempt))
        with self._metrics_lock:
            self.metrics.quorum_failures += 1
        tr = self.obs.tracer if self.obs is not None else None
        if tr is not None:
            tr.instant("quorum-unreachable", service=ds.ds_id, oid=oid,
                       wanted=want, got=len(reachable))
        raise QuorumUnreachable(oid, want, len(reachable))

    def app_access(self, ctx: ExecutionContext, oid: int) -> PersistentObject:
        """Navigate to ``oid`` on the application thread: redirect execution
        to a replica holding the object (load-aware choice under
        replication), then ensure the object is in that service's memory —
        failing over to another replica if the service turns out dead."""
        ds, did_load = self._demand_load(ctx, oid)
        with self._metrics_lock:
            self.metrics.app_loads += 1
            if did_load:
                self.metrics.app_cache_misses += 1
            else:
                self.metrics.app_cache_hits += 1
            self.accessed_oids.add(oid)
            if self.trace is not None:
                self.trace.append(access_event(oid))
        self._notify(oid, did_load)
        self.latency.sleep(self.latency.think)
        return ds.disk[oid]

    def app_write(self, oid: int, ctx: Optional[ExecutionContext] = None) -> None:
        """Update ``oid`` on the application thread.  Writes are demand
        accesses like any other: execution redirects to the owning Data
        Service, an uncached object is write-allocated (the disk load counts
        as a miss), the dirty bit defers ``write_back`` to eviction/flush,
        and the access is visible to tracing, ``accessed_oids`` and the
        listeners — previously all of this was bypassed and mutating
        workloads undercounted demand."""
        ds, did_load = self._demand_load(ctx, oid, write=True)
        if self.write_quorum > 1:
            self._await_write_quorum(oid, ds)
        reps = self._placement[oid]
        with self._metrics_lock:
            self.metrics.writes += 1
            if did_load:
                self.metrics.app_cache_misses += 1
            else:
                self.metrics.write_hits += 1
            self.accessed_oids.add(oid)
            if self.trace is not None:
                self.trace.append(write_event(oid))
            # anti-entropy log: replicas that cannot see this write (dead
            # or across the partition) resync the line at readmission
            if len(reps) > 1:
                for r in reps:
                    if r == ds.ds_id:
                        continue
                    if (r in self._net_cut or r in self._down
                            or not self.services[r].alive):
                        self._missed_writes.setdefault(r, set()).add(oid)
        self._notify(oid, did_load)
        # per-object application processing charges on writes exactly like
        # reads — the virtual-clock replay does the same, keeping the two
        # timelines comparable
        self.latency.sleep(self.latency.think)

    def trace_method_entry(self, method_key: str, oid: int) -> None:
        """Record entry into a registered method (the injected scheduling
        point) in the event trace — no cost, pure bookkeeping."""
        with self._metrics_lock:
            if self.trace is not None:
                self.trace.append(method_entry_event(method_key, oid))

    def _note_dirty_eviction(self) -> None:
        with self._metrics_lock:
            self.metrics.dirty_evictions += 1

    def _note_flush(self) -> None:
        with self._metrics_lock:
            self.metrics.flushed_writes += 1

    # -- prefetch-path access ----------------------------------------------

    def prefetch_access(self, oid: int, origin: str = "", rfo: bool = False,
                        session: str = "") -> PersistentObject:
        """Per-oid prefetch: load ``oid`` into its own Data Service's memory
        (no execution redirection: 'dataClay ... loads the object where it
        is stored').  This is the legacy one-task-per-oid dispatch target
        (``dispatch="per-oid"``); each call was one executor submission, so
        it also counts one ``batch_dispatches``.  ``rfo`` dirty-allocates
        the line (the static optimizer marked it a known update site)."""
        with self._prefetch_lock:
            self.prefetched_oids.add(oid)
        ds = self._route_prefetch(oid)
        if ds is None:
            return self.record(oid)  # no reachable replica: skip quietly
        tr = self.obs.tracer if self.obs is not None else None
        if tr is not None:
            tr.predicted([oid], origin, session=session)
            tr.dispatched([oid], ds.ds_id, tr.new_batch(), session=session)
            t_q = time.perf_counter()
            tr.claimed([oid], ds.ds_id, t=t_q)
        try:
            if ds.ds_id in self._net_cut:
                raise ServiceCrashed(ds.ds_id)
            did_load = ds.load_into_memory(oid, prefetch=True, rfo=rfo)
        except ServiceCrashed:
            self._note_service_down(ds.ds_id)
            self._failover_redispatch(
                ds.ds_id, [oid], rfo=frozenset([oid]) if rfo else frozenset(),
                session=session)
            return self.record(oid)
        if tr is not None:
            if did_load:
                # per-oid loads have no slot-wait visibility: the whole
                # load_into_memory window counts as queue+disk
                tr.loaded([oid], ds.ds_id, 0, t_q, t_q, time.perf_counter())
            else:
                tr.suppressed([oid], ds.ds_id)
        with ds._cache_lock:
            ds.prefetch_requests += 1
            ds.batch_dispatches += 1
            if did_load:
                ds.prefetch_loads += 1
        return ds.disk[oid]

    def prefetch_batch(self, oids: Iterable[int], runtime=None,
                       origin: str = "", rfo: Iterable[int] = (),
                       priorities: Optional[dict[int, float]] = None,
                       session: str = "") -> int:
        """Batched, placement-aware prefetch dispatch: group the predicted
        ``oids`` (already in predicted-need order) by owning Data Service,
        dedupe each group against that service's cache *and* in-flight loads
        under one snapshot read, and submit **one batch task per Data
        Service** whose worker pipelines the surviving loads through the
        service's ``parallel_per_ds`` slots.  All requested oids count as
        prefetched for accuracy (exactly what the per-oid path records);
        suppressed ones are tallied in the per-service ``dedup_suppressed``.
        Without a ``runtime`` the batches load on the calling thread.
        Returns the number of batch tasks submitted.

        Static-optimizer signals: oids in ``rfo`` dirty-allocate on landing
        (read-for-ownership); ``priorities`` (oid -> static dispatch
        priority) orders the per-service groups most-valuable-first and
        feeds the runtime's admission control — a saturated runtime sheds
        the cheap-to-skip expensive tail (``runtime.admit``) instead of
        queueing unboundedly.

        Under replication the grouping routes each oid to its best replica
        (cached/least-queued), and a batch that lands on a service that
        crashed between routing and claiming is re-dispatched to the
        survivors instead of being lost."""
        oids = list(oids)
        rfo = frozenset(rfo)
        groups: dict[int, list[int]] = {}
        skipped = 0
        for oid in oids:
            ds = self._route_prefetch(oid)
            if ds is None:
                skipped += 1  # unreachable: demand will surface it if needed
                continue
            groups.setdefault(ds.ds_id, []).append(oid)
        with self._prefetch_lock:
            self.prefetched_oids.update(oids)
        if not groups:
            return 0
        ordered = list(groups.items())
        if priorities:
            # highest-priority group first (stable on the original
            # predicted-need grouping order for ties)
            ordered.sort(key=lambda kv: -max(
                (priorities.get(o, 0.0) for o in kv[1]), default=0.0))
        tr = self.obs.tracer if self.obs is not None else None
        submitted = 0
        for ds_id, batch in ordered:
            ds = self.services[ds_id]
            if tr is not None:
                tr.predicted(batch, origin, session=session)
            if runtime is not None and priorities is not None:
                prio = max((priorities.get(o, 0.0) for o in batch),
                           default=0.0)
                if not runtime.admit(prio):
                    if tr is not None:
                        tr.dropped(batch, "admission")
                    continue
            if tr is not None:
                tr.dispatched(batch, ds_id, tr.new_batch(), session=session)
            try:
                if ds_id in self._net_cut:
                    raise ServiceCrashed(ds_id)
                todo = ds.claim_prefetch_batch(batch)
            except ServiceCrashed:
                self._note_service_down(ds_id)
                self._failover_redispatch(ds_id, batch, runtime=runtime,
                                          origin=origin, rfo=rfo,
                                          session=session)
                continue
            if tr is not None:
                if todo:
                    tr.claimed(todo, ds_id)
                won = set(todo)
                lost = [o for o in batch if o not in won]
                if lost:
                    tr.suppressed(lost, ds_id)
            if not todo:
                continue
            submitted += 1
            todo_rfo = rfo.intersection(todo)
            if runtime is not None:
                runtime.submit(ds.load_batch, todo, True, runtime, todo_rfo)
            else:
                ds.load_batch(todo, rfo=todo_rfo)
        return submitted

    def peek(self, oid: int) -> PersistentObject:
        """Read a record without cost accounting (builders / assertions)."""
        return self.record(oid)

    # -- failure injection & detection ---------------------------------------

    def crash_service(self, ds_id: int, announce: bool = True) -> None:
        """Fail-stop one Data Service: its memory cache and in-flight loads
        are gone (disk records survive on the replicas).  ``announce=False``
        models a *silent* failure — routing keeps sending traffic there
        until the error path or the heartbeat monitor notices."""
        self.services[ds_id].crash()
        with self._metrics_lock:
            self.metrics.services_crashed += 1
        tr = self.obs.tracer if self.obs is not None else None
        if tr is not None:
            tr.instant("service-crash", service=ds_id)
        if announce:
            self._note_service_down(ds_id)

    def partition(self, groups: Iterable[Iterable[int]],
                  announce: bool = True) -> None:
        """Cut the network into ``groups`` of service ids: group 0 is the
        client-side majority (services listed in no group implicitly belong
        to it); every service outside group 0 becomes unreachable — demand
        and prefetch traffic to it fails like :class:`ServiceCrashed` and
        routing degrades to the reachable replicas.  Unlike a crash the cut
        services keep their memory state: at ``heal_partition`` they rejoin
        warm and resync only the writes they missed.  ``announce=False``
        models an undetected cut (traffic keeps flowing until the error
        path notices)."""
        groups = [tuple(g) for g in groups]
        cut = {ds_id for grp in groups[1:] for ds_id in grp}
        self._net_cut = cut
        with self._metrics_lock:
            self.metrics.partitions += 1
        tr = self.obs.tracer if self.obs is not None else None
        if tr is not None:
            tr.instant("partition", cut=sorted(cut))
        if announce:
            for ds_id in cut:
                self._note_service_down(ds_id)

    def heal_partition(self) -> None:
        """Heal the network cut: every cut service readmits into routing
        (warm cache — nothing was lost, only unreachable) and anti-entropy
        resyncs the dirty lines whose writes it missed."""
        cut, self._net_cut = self._net_cut, set()
        for ds_id in sorted(cut):
            self._readmit(ds_id)
        tr = self.obs.tracer if self.obs is not None else None
        if tr is not None:
            tr.instant("partition-heal", healed=sorted(cut))

    def revive_service(self, ds_id: int) -> None:
        """Bring a crashed service back: cold cache, healthy routing state,
        heartbeat/straggler detector readmission, and anti-entropy resync
        of the writes it missed while dead."""
        self.services[ds_id].revive()
        self._readmit(ds_id)
        tr = self.obs.tracer if self.obs is not None else None
        if tr is not None:
            tr.instant("service-readmit", service=ds_id)

    # back-compat alias (pre-recovery API)
    def restore_service(self, ds_id: int) -> None:
        self.revive_service(ds_id)

    def _readmit(self, ds_id: int) -> None:
        """Shared readmission path (heal + revive): routing forgets the
        down/straggler flags, the fault detector resets the service's
        baseline, missed writes resync, and the readmission is counted."""
        self._down.discard(ds_id)
        self._slow.discard(ds_id)
        if self.fault is not None:
            self.fault.readmit(ds_id)
        resynced = self._resync_missed(ds_id)
        with self._metrics_lock:
            self.metrics.readmissions += 1
            self.metrics.resync_lines += resynced

    def _resync_missed(self, ds_id: int) -> int:
        """Anti-entropy replay of the write log a returning replica missed:
        each missed oid costs the replica one write-back (off the
        application's critical path — charged on the replica's own disk
        slots).  Returns the number of lines resynced."""
        with self._metrics_lock:
            missed = self._missed_writes.pop(ds_id, set())
        ds = self.services[ds_id]
        count = 0
        for oid in sorted(missed):
            if oid in ds.disk:
                ds._flush(oid)
                count += 1
        return count

    def _flush_failover(self, from_ds: int, oid: int) -> bool:
        """A dirty flush landed on a dead service: perform the write-back
        on a live reachable replica instead of dropping the update.  False
        when no replica can take it (the caller counts a lost write)."""
        reps = self._placement.get(oid, ())
        for r in reps:
            if r == from_ds:
                continue
            svc = self.services[r]
            if svc.alive and r not in self._net_cut and oid in svc.disk:
                svc._flush(oid)
                return True
        return False

    def _note_lost_write(self, ds_id: int, oid: int) -> None:
        with self._metrics_lock:
            self.metrics.lost_writes += 1
        tr = self.obs.tracer if self.obs is not None else None
        if tr is not None:
            tr.instant("lost-write", service=ds_id, oid=oid)

    def attach_fault_detection(self, **kwargs) -> "Any":
        """Wire the ``runtime.fault`` machinery (HeartbeatMonitor +
        StragglerDetector) into this store: landed loads beat, the demand
        path ticks, missed beats mark services down and persistent disk-time
        outliers get deprioritized by routing."""
        from ..runtime.fault import StoreFaultDetector

        self.fault = StoreFaultDetector(self, **kwargs)
        return self.fault

    def _note_service_down(self, ds_id: int) -> None:
        """Record a detected-dead service (error path, heartbeat timeout or
        explicit announce); idempotent, routing avoids it from now on."""
        if ds_id in self._down:
            return
        self._down.add(ds_id)
        tr = self.obs.tracer if self.obs is not None else None
        if tr is not None:
            tr.instant("service-down", service=ds_id)

    def _note_straggler(self, ds_id: int) -> None:
        """Record a detector-flagged straggler: routing deprioritizes it
        when a healthier replica exists (it stays available — slow, not
        dead)."""
        if ds_id in self._slow:
            return
        self._slow.add(ds_id)
        with self._metrics_lock:
            self.metrics.stragglers_flagged += 1
        tr = self.obs.tracer if self.obs is not None else None
        if tr is not None:
            tr.instant("straggler-flagged", service=ds_id)

    def _failover_redispatch(self, from_ds: int, oids: list[int],
                             runtime=None, origin: str = "failover",
                             rfo: frozenset = frozenset(),
                             session: str = "") -> int:
        """Re-dispatch prefetch oids that were claimed by (or headed for) a
        service that died before landing them.  Routing now avoids the dead
        service, so the batch re-groups onto surviving replicas; with
        replication 1 there is nowhere to go and the oids fall back to
        demand misses.  RFO marks survive the re-dispatch."""
        if not oids:
            return 0
        with self._metrics_lock:
            self.metrics.failovers += 1
        tr = self.obs.tracer if self.obs is not None else None
        if tr is not None:
            tr.dropped(oids, "service-crash")
            tr.instant("prefetch-failover", service=from_ds, oids=len(oids))
        return self.prefetch_batch(oids, runtime=runtime,
                                   origin=origin or "failover",
                                   rfo=rfo.intersection(oids),
                                   session=session)

    # -- bookkeeping ---------------------------------------------------------

    def snapshot_metrics(self) -> dict[str, int]:
        """One coherent metrics read: the application-path ``StoreMetrics``
        plus the per-service prefetch counters summed across Data Services
        (the per-oid prefetch path used to update the store-wide metrics
        under the same lock the application thread takes on every access —
        aggregation now happens here, on read, instead)."""
        with self._metrics_lock:
            out = self.metrics.snapshot()
        for key in PREFETCH_COUNTERS:
            out[key] = 0
        for ds in self.services:
            with ds._cache_lock:
                for key in PREFETCH_COUNTERS:
                    out[key] += getattr(ds, key)
        return out

    def register_runtime(self, runtime) -> None:
        """Attach a live PrefetchRuntime (Session does this) so
        ``reset_runtime_state`` can drain outstanding prefetch work."""
        self._runtimes.add(runtime)

    def unregister_runtime(self, runtime) -> None:
        self._runtimes.discard(runtime)

    def protected_evictions(self) -> int:
        """Evictions where the policy passed over protected prefetched
        lines (store-wide; the shared budget's policy already spans all
        services, so count each policy instance once)."""
        policies = {id(ds.policy): ds.policy for ds in self.services}
        return sum(p.protected_evictions for p in policies.values())

    def reset_runtime_state(self, drain_timeout: float = 5.0) -> None:
        """Drop all caches and counters (between benchmark repetitions).
        Any Session-attached PrefetchRuntime is drained first — straggler
        prefetch tasks from repetition *k* used to keep loading into the
        freshly reset caches and pollute repetition *k+1*'s metrics; a
        drain timeout is now surfaced as a warning and the runtime is
        hard-drained (queued work cancelled) rather than ignored.
        ``drop_cache`` then flushes dirty write-back state; the per-service
        counters (``evictions`` et al.) are zeroed too — they used to
        survive resets and accumulate across repetitions."""
        for runtime in list(self._runtimes):
            if not runtime.drain(drain_timeout):
                import warnings

                warnings.warn(
                    "prefetch work still outstanding at reset_runtime_state "
                    f"after {drain_timeout}s; hard-draining so stragglers "
                    "cannot pollute the next repetition",
                    RuntimeWarning,
                    stacklevel=2,
                )
                runtime.hard_drain(drain_timeout)
        if self.obs is not None and self.obs.tracer is not None:
            # lifecycle invariant through resets: whatever is still live
            # (cancelled work, never-demanded residents) terminates now
            self.obs.tracer.drop_active("drained")
        for ds in self.services:
            ds.drop_cache()
            ds.reset_counters()
        if self.budget is not None:
            self.budget.reset()
        with self._metrics_lock:
            self.metrics = StoreMetrics()
            self.accessed_oids = set()
            self.prefetched_oids = set()
            self.failovers_by_session = {}
            self._missed_writes = {}
            if self.trace is not None:
                self.trace = []

    # -- accuracy ------------------------------------------------------------

    def prefetch_accuracy(self) -> dict[str, float]:
        """True positives: prefetched & accessed. False positives: prefetched
        but never accessed. False negatives: accessed but never prefetched."""
        return prefetch_accuracy(self.prefetched_oids, self.accessed_oids)

    def populate_collection(self, cls: str, payloads: Iterable[dict[str, Any]],
                            groups: Optional[Iterable[Optional[str]]] = None) -> list[int]:
        """Store many objects of one class distributed across Data Services
        by the placement policy (how dataClay distributes a stored
        collection).  ``groups`` optionally supplies one locality hint per
        payload (element subtree keys for the locality policy)."""
        if groups is None:
            return [self.put(cls, p) for p in payloads]
        return [self.put(cls, p, group=g) for p, g in zip(payloads, groups)]
