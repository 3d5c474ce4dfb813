"""Prefetch execution runtime (paper sections 5.2.2-5.2.3).

Mirrors the generated Java code:

  * a **single-thread** scheduling executor (the injected
    ``Executors.newFixedThreadPool(1)``) runs the generated prefetch methods
    one after another in the background, so the application thread is never
    interrupted;
  * inside a prefetch method, collection hints fan out over a **shared
    parallel pool** (the JVM parallel-streams ForkJoin pool; its size is the
    number of cores).  Fan-out tasks are non-blocking — a task loads its
    object and submits its children — so nested collections cannot starve
    the bounded pool.

Dispatch granularity is the caller's choice: ``fan_out`` submits one task
per item (the historical per-oid dispatch), ``submit`` submits a single
task for an already-grouped batch (``ObjectStore.prefetch_batch`` uses one
per Data Service).  Every submission is tracked so ``drain`` knows when the
runtime is idle, and ``hard_drain`` can cancel work that never started —
straggler tasks from one benchmark repetition used to keep running into
the next because ``drain``'s timeout result was silently ignored.
"""

from __future__ import annotations

import threading
import warnings
from concurrent.futures import ThreadPoolExecutor


class PrefetchRuntime:
    def __init__(self, parallel_workers: int = 8,
                 max_outstanding: int = 0, admission_threshold: float = 0.0):
        self._scheduler = ThreadPoolExecutor(max_workers=1, thread_name_prefix="prefetch-sched")
        self._pool = ThreadPoolExecutor(max_workers=parallel_workers, thread_name_prefix="prefetch-par")
        self.parallel_workers = parallel_workers
        self._outstanding = 0
        self._lock = threading.Lock()
        self._idle = threading.Event()
        self._idle.set()
        self._futures: set = set()
        self.scheduled = 0
        self.submitted_tasks = 0  # every executor submission (sched + pool)
        # admission control (static-optimizer priority signal): when more
        # than ``max_outstanding`` tasks are outstanding, only batches whose
        # priority clears ``admission_threshold`` are admitted — the
        # expensive tail is shed instead of queueing unboundedly.
        # max_outstanding == 0 disables shedding (the default: the paper's
        # runtime never drops work).
        self.max_outstanding = max_outstanding
        self.admission_threshold = admission_threshold
        self.admission_dropped = 0  # batches shed by admission control

    # -- task accounting -----------------------------------------------------

    def _inc(self) -> None:
        with self._lock:
            self._outstanding += 1
            self.submitted_tasks += 1
            self._idle.clear()

    def _dec(self) -> None:
        with self._lock:
            self._outstanding -= 1
            if self._outstanding == 0:
                self._idle.set()

    def _wrap(self, fn, *args):
        try:
            fn(*args)
        finally:
            self._dec()

    def _track(self, fut) -> None:
        with self._lock:
            self._futures.add(fut)
        fut.add_done_callback(self._untrack)

    def _untrack(self, fut) -> None:
        with self._lock:
            self._futures.discard(fut)
        if fut.cancelled():
            # the wrapped fn never ran, so its _dec never fired
            self._dec()

    # -- API -----------------------------------------------------------------

    def stats(self) -> dict:
        """Queue-depth snapshot for the observability registry (a Session
        registers this as a ``runtime`` source)."""
        with self._lock:
            return {
                "scheduled": self.scheduled,
                "submitted_tasks": self.submitted_tasks,
                "outstanding": self._outstanding,
                "admission_dropped": self.admission_dropped,
            }

    def admit(self, priority: float = 0.0) -> bool:
        """Admission decision for a prefetch batch carrying a static
        ``priority`` (core.opt's cost model, higher = cheaper/sooner
        demanded).  Always True while the runtime has headroom; once
        ``max_outstanding`` tasks are outstanding only priorities >=
        ``admission_threshold`` get in."""
        if not self.max_outstanding:
            return True
        with self._lock:
            if self._outstanding < self.max_outstanding:
                return True
            if priority >= self.admission_threshold:
                return True
            self.admission_dropped += 1
            return False

    def schedule(self, fn) -> None:
        """Submit a generated prefetch method to the background executor
        (the paper's injected ``prefetchingExecutor.submit``)."""
        self.scheduled += 1
        self._inc()
        self._track(self._scheduler.submit(self._wrap, fn))

    def submit(self, fn, *args) -> None:
        """Submit ONE task to the shared parallel pool — the batched
        dispatch entry point (one grouped request per Data Service instead
        of one task per oid).  Non-blocking."""
        self._inc()
        self._track(self._pool.submit(self._wrap, fn, *args))

    def fan_out(self, fn, items) -> None:
        """Parallel-streams analogue: run ``fn(item)`` on the shared pool.
        Non-blocking: returns immediately."""
        for it in items:
            self._inc()
            self._track(self._pool.submit(self._wrap, fn, it))

    def drain(self, timeout: float = 60.0) -> bool:
        """Wait until all scheduled prefetch work has finished.  Returns
        False on timeout — callers that reset shared state next should
        treat that as a leak (see ``hard_drain``)."""
        return self._idle.wait(timeout)

    def hard_drain(self, timeout: float = 5.0) -> bool:
        """Drain, and on timeout cancel every queued-but-unstarted task so
        stragglers cannot touch store state later.  Already-running tasks
        cannot be interrupted — the final wait gives them ``timeout`` more
        seconds to finish."""
        if self._idle.wait(timeout):
            return True
        with self._lock:
            pending = list(self._futures)
        for fut in pending:
            fut.cancel()
        return self._idle.wait(timeout)

    def shutdown(self, timeout: float = 5.0) -> None:
        if not self.hard_drain(timeout):
            warnings.warn(
                f"prefetch runtime still busy after {timeout}s at shutdown; "
                "running straggler tasks will be awaited by the executor",
                RuntimeWarning,
                stacklevel=2,
            )
        self._scheduler.shutdown(wait=True, cancel_futures=True)
        self._pool.shutdown(wait=True, cancel_futures=True)
