"""Pluggable cache-eviction policies shared by the live store and the
virtual-clock replay engine (DESIGN.md section 3.5).

CAPre's speedups assume prefetched objects *survive* in cache until their
access.  Whether they do is decided by the eviction policy, so the policy is
a first-class, swappable subsystem: ``pos.store.DataService`` (real threads,
real sleeps) and ``predict.evaluate.VirtualReplay`` (deterministic virtual
clock) both drive the classes below, so simulated and measured thrash come
from one code path.

A policy owns only the *ordering metadata* (which resident line to evict
next); residency itself — the cache dict, dirty bits, in-flight loads —
stays with the host.  The host contract, always under the host's cache lock
(policies are not thread-safe on their own):

  * ``note_insert(oid, prefetch=..., used=...)`` — a line became resident;
  * ``note_access(oid, prefetch=...)``           — a resident line was
    touched (``prefetch=True`` for prefetch-path touches, which must not
    count as the application *using* the line);
  * ``pick_victim()``  — choose + forget the line to evict (host removes it);
  * ``note_remove(oid)`` — a line left the cache outside eviction
    (``drop_cache``);
  * ``reset()``        — forget everything, zero counters.

Policies (``make_policy`` / ``POLICIES``):

  ================  ========================================================
  ``lru``           evict the least-recently-touched line (the store's
                    historical behavior; prefetch touches bump recency too)
  ``fifo``          evict in insertion order; touches never reorder
  ``clock``         second-chance FIFO: a touched line gets its reference
                    bit cleared and one more trip around before eviction
  ``lfu``           evict the least-frequently-touched line (ties broken
                    least-recently-used)
  ``prefetch-aware``protect the *oldest* ``window`` not-yet-used prefetched
                    lines (the ones the application will need soonest —
                    prefetchers emit in traversal order); evict used/demand
                    lines LRU-first, then the *newest* unused prefetch
                    (MRU among the flood, the classic sequential-scan
                    anti-LRU move), and only then a protected line
  ================  ========================================================

``protected_evictions`` counts victim selections where the policy passed
over at least one protected prefetched line — the metric that shows the
prefetch-aware policy actually intervened (it lands on the ``Overhead``
ledger and in the replay CSV).

``SharedBudget`` implements the shared-memory-budget mode: instead of a
fixed per-service capacity, every Data Service draws lines from one global
budget and overflow evicts the policy's globally-worst line *wherever it
lives* (policy-mediated stealing).  One policy instance spans all services;
the budget tracks which service owns each resident line and hands the host
``(owner, victim)`` pairs so dirty flushes charge the victim's own disk.
"""

from __future__ import annotations

import threading
from typing import Optional


class EvictionPolicy:
    """Base class: insertion-ordered metadata + counters.  Subclasses
    override ``note_access`` / ``pick_victim``."""

    name = "?"

    def __init__(self, capacity: int = 0):
        self.capacity = capacity  # informational; hosts enforce it
        self._lines: dict[int, None] = {}  # insertion/recency order
        self.protected_evictions = 0

    # -- host contract ------------------------------------------------------

    def note_insert(self, oid: int, prefetch: bool = False, used: bool = False) -> None:
        self._lines[oid] = None

    def note_access(self, oid: int, prefetch: bool = False) -> None:
        """A resident line was touched.  Default: no reordering (FIFO)."""

    def pick_victim(self) -> int:
        """Choose the line to evict and forget its metadata.  Hosts only
        call this while at least one line is resident."""
        victim = next(iter(self._lines))
        del self._lines[victim]
        return victim

    def note_remove(self, oid: int) -> None:
        self._lines.pop(oid, None)

    def reset(self) -> None:
        self._lines.clear()
        self.protected_evictions = 0

    # -- introspection (tests / invariant checks) ---------------------------

    def tracked(self) -> set[int]:
        """The lines this policy believes are resident — property tests
        assert this stays identical to the host's cache membership."""
        return set(self._lines)

    def __len__(self) -> int:
        return len(self._lines)


class FIFOPolicy(EvictionPolicy):
    name = "fifo"


class LRUPolicy(EvictionPolicy):
    name = "lru"

    def note_access(self, oid: int, prefetch: bool = False) -> None:
        self._lines.pop(oid, None)
        self._lines[oid] = None


class ClockPolicy(EvictionPolicy):
    """Second-chance FIFO: the hand sweeps insertion order; a referenced
    line is spared once (bit cleared, moved to the back) instead of
    maintaining strict recency order."""

    name = "clock"

    def __init__(self, capacity: int = 0):
        super().__init__(capacity)
        self._ref: dict[int, bool] = {}

    def note_insert(self, oid: int, prefetch: bool = False, used: bool = False) -> None:
        super().note_insert(oid, prefetch=prefetch, used=used)
        self._ref[oid] = False

    def note_access(self, oid: int, prefetch: bool = False) -> None:
        self._ref[oid] = True

    def pick_victim(self) -> int:
        while True:
            oid = next(iter(self._lines))
            if self._ref.get(oid, False):
                self._ref[oid] = False
                del self._lines[oid]
                self._lines[oid] = None  # one more trip around
                continue
            del self._lines[oid]
            self._ref.pop(oid, None)
            return oid

    def note_remove(self, oid: int) -> None:
        super().note_remove(oid)
        self._ref.pop(oid, None)

    def reset(self) -> None:
        super().reset()
        self._ref.clear()


class LFUPolicy(EvictionPolicy):
    name = "lfu"

    def __init__(self, capacity: int = 0):
        super().__init__(capacity)
        self._freq: dict[int, int] = {}

    def note_insert(self, oid: int, prefetch: bool = False, used: bool = False) -> None:
        super().note_insert(oid, prefetch=prefetch, used=used)
        self._freq[oid] = 1

    def note_access(self, oid: int, prefetch: bool = False) -> None:
        self._freq[oid] = self._freq.get(oid, 0) + 1
        self._lines.pop(oid, None)  # keep recency for tie-breaks
        self._lines[oid] = None

    def pick_victim(self) -> int:
        # least frequency, ties least-recently-used; O(n) scan is fine at
        # the line counts these caches run (the replay sweeps <= a few
        # hundred lines)
        victim = min(self._lines, key=lambda o: self._freq.get(o, 0))
        del self._lines[victim]
        self._freq.pop(victim, None)
        return victim

    def note_remove(self, oid: int) -> None:
        super().note_remove(oid)
        self._freq.pop(oid, None)

    def reset(self) -> None:
        super().reset()
        self._freq.clear()


class PrefetchAwarePolicy(EvictionPolicy):
    """Protect not-yet-used prefetched lines for a bounded window.

    Prefetchers emit lines in traversal order, so under a flood the *oldest*
    unused prefetched lines are exactly the ones the application will touch
    next — and plain LRU evicts them first (sequential floods are LRU's
    pathological case).  This policy keeps a bounded window of the oldest
    unused prefetched lines resident; victim preference:

      1. unused prefetched lines *beyond* the protection window, newest
         first — the tail of a flood is bypassed rather than allowed to
         thrash either the flood's head or the application's working set;
      2. then used / demand-loaded lines, least-recently-used (so a demand
         line inserted into a cache full of protected prefetches never
         evicts itself while flood tail exists);
      3. only when every resident line is protected, fall back to the
         oldest prefetched line (capacity is a hard bound).

    A line leaves the protected class the moment the application uses it.
    ``window`` bounds how many unused prefetched lines are protected at
    once; the default — half the cache capacity — splits the cache between
    the flood head and the re-accessed working set, which on the benchmark
    traces dominates both the whole-cache window (starves reuse-heavy
    traversals like oo7) and tick-based expiry (gives up the flood head
    before the application reaches it)."""

    name = "prefetch-aware"

    def __init__(self, capacity: int = 0, window: Optional[int] = None):
        super().__init__(capacity)
        self.window = window if window is not None else max(1, capacity // 2)
        self._recency: dict[int, None] = {}  # used/demand lines, LRU order
        self._pending: dict[int, None] = {}  # unused prefetched, insert order

    def note_insert(self, oid: int, prefetch: bool = False, used: bool = False) -> None:
        super().note_insert(oid, prefetch=prefetch, used=used)
        if prefetch and not used:
            self._pending[oid] = None
        else:
            self._recency[oid] = None

    def note_access(self, oid: int, prefetch: bool = False) -> None:
        if oid not in self._lines:
            return
        if not prefetch and oid in self._pending:
            # the application used the prefetched line: protection ends
            del self._pending[oid]
        if oid not in self._pending:
            self._recency.pop(oid, None)
            self._recency[oid] = None

    def pick_victim(self) -> int:
        # protected_evictions counts evictions where at least one protected
        # (in-window, not-yet-used prefetched) line was spared
        if len(self._pending) > self.window:
            victim = next(reversed(self._pending))  # newest beyond the window
            del self._pending[victim]
            self.protected_evictions += 1
        elif self._recency:
            victim = next(iter(self._recency))
            del self._recency[victim]
            if self._pending:
                self.protected_evictions += 1
        else:
            victim = next(iter(self._pending))  # forced: everything protected
            del self._pending[victim]
        del self._lines[victim]
        return victim

    def note_remove(self, oid: int) -> None:
        super().note_remove(oid)
        self._recency.pop(oid, None)
        self._pending.pop(oid, None)

    def reset(self) -> None:
        super().reset()
        self._recency.clear()
        self._pending.clear()


POLICIES: dict[str, type[EvictionPolicy]] = {
    cls.name: cls
    for cls in (LRUPolicy, FIFOPolicy, ClockPolicy, LFUPolicy, PrefetchAwarePolicy)
}

DEFAULT_POLICY = "lru"


def make_policy(name: str = DEFAULT_POLICY, capacity: int = 0, **kwargs) -> EvictionPolicy:
    try:
        cls = POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown eviction policy {name!r}; available: {sorted(POLICIES)}")
    return cls(capacity=capacity, **kwargs)


class SharedBudget:
    """One global line budget drawn on by every Data Service (the
    shared-memory-budget mode): a single policy instance orders all resident
    lines store-wide, and overflow evicts the globally-worst line wherever
    it lives.  ``owner`` maps each resident oid to the *set* of objects
    holding a copy of its cache line (``DataService`` instances, or
    Data-Service indices in the replay engine) — with replication >= 2 the
    same oid can be resident on several replicas at once (failover and
    hedged reads land second copies), and all copies share one budget line:
    the policy tracks the oid once, and eviction drops every copy together.
    ``lock`` is the one cache lock every service shares in this mode, so
    cross-service victim selection is race-free."""

    def __init__(self, capacity: int, policy: str = DEFAULT_POLICY, **kwargs):
        self.capacity = capacity
        self.policy = make_policy(policy, capacity=capacity, **kwargs)
        self.owner: dict[int, set] = {}
        self.lock = threading.Lock()

    def note_insert(self, oid: int, owner, prefetch: bool = False, used: bool = False) -> None:
        holders = self.owner.get(oid)
        if holders is None:
            self.owner[oid] = {owner}
            self.policy.note_insert(oid, prefetch=prefetch, used=used)
        else:
            # an additional replica copy of an already-tracked line: bump
            # the existing policy entry instead of re-inserting (a second
            # note_insert would double-register the line in stateful
            # policies like prefetch-aware)
            holders.add(owner)
            self.policy.note_access(oid, prefetch=prefetch)

    def note_remove(self, oid: int, owner=None) -> None:
        """One holder dropped its copy (``owner``), or — with no owner —
        the line vanished everywhere.  The policy forgets the oid only when
        the last copy goes: a surviving replica's copy must stay evictable,
        or its next touch resurrects an ownerless policy entry and a later
        ``pick_victim`` crashes on it."""
        holders = self.owner.get(oid)
        if holders is None:
            return
        if owner is not None:
            holders.discard(owner)
        else:
            holders.clear()
        if not holders:
            del self.owner[oid]
            self.policy.note_remove(oid)

    def overflowed(self) -> bool:
        return bool(self.capacity) and len(self.owner) > self.capacity

    def pick_victim(self) -> tuple[set, int]:
        """Choose the globally-worst line; returns the full holder set —
        the caller evicts the line from every holder."""
        victim = self.policy.pick_victim()
        return self.owner.pop(victim), victim

    def reset(self) -> None:
        self.owner.clear()
        self.policy.reset()
