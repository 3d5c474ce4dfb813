"""Pluggable object-placement policies for the distributed store.

Eviction is a policy (``eviction.py``); this module does the same for *topology*.
``ObjectStore.put`` delegates the "which Data Service owns this object"
decision (plus its replica set) to a :class:`PlacementPolicy`:

  * ``round-robin`` — the dataClay default this repo has always modeled
    ("stored collections are automatically distributed among the available
    Data Services"): one global counter, one service per put.  Byte-exact
    with the historical inline ``next(count) % n`` so the committed
    baseline.csv replays identically under it.
  * ``consistent-hash`` — a virtual-node hash ring (sha1, 64 vnodes per
    service).  Placement becomes a pure function of the oid: no shared
    counter, minimal movement when the service count changes — the
    standard distributed-KV layout (Palpatine's substrate).
  * ``locality`` — co-locates *hint-tree subtrees*: a put may carry a
    ``group`` key (the apps tag each collection element's subtree — a bank
    transaction with its account/customer chain, an oo7 composite part
    with its atomic parts and connections); every object of one group
    lands on one service, and the groups themselves round-robin for
    balance.  One ``prefetch_batch`` of one subtree then becomes ONE
    service batch instead of fanning out across the cluster — trading
    cross-service parallelism for dispatch locality (measured by
    ``benchmarks/bench_placement.py``).

Replication: every policy returns a replica *set* (primary first) of
``replication`` distinct services; the spread is primary + successors on
the service ring, so two replicas never share a service.

All policies are deterministic: same put sequence (and group keys) =>
same placement, which is what lets the virtual-clock replay re-place a
recorded store (``ObjectStore.rebuild_placement``) and sweep placement
policies without re-recording traces.
"""

from __future__ import annotations

import bisect
import hashlib
import itertools
from typing import Optional


def spread(primary: int, n_services: int, replication: int) -> tuple[int, ...]:
    """Replica set for ``primary``: itself plus the next ``replication - 1``
    distinct services on the ring (primary first — read routing prefers
    earlier replicas on ties)."""
    r = max(1, min(replication, n_services))
    return tuple((primary + k) % n_services for k in range(r))


class PlacementPolicy:
    """Host contract: ``place`` is called once per unpinned ``put`` in
    creation order and returns the object's replica set (primary first).
    State (counters, group maps) must be deterministic in the call
    sequence — ``reset`` rewinds it for a re-placement pass."""

    name = "base"

    def __init__(self, n_services: int, replication: int = 1):
        self.n_services = n_services
        self.replication = max(1, min(replication, n_services))

    def place(self, oid: int, cls: str, group: Optional[str] = None) -> tuple[int, ...]:
        raise NotImplementedError

    def spread(self, primary: int) -> tuple[int, ...]:
        return spread(primary, self.n_services, self.replication)

    def reset(self) -> None:
        pass


class RoundRobinPlacement(PlacementPolicy):
    """One shared counter, one service per put — the dataClay distribution
    the paper's parallel prefetching exploits.  Group keys are ignored."""

    name = "round-robin"

    def __init__(self, n_services: int, replication: int = 1):
        super().__init__(n_services, replication)
        self._rr = itertools.count()

    def place(self, oid: int, cls: str, group: Optional[str] = None) -> tuple[int, ...]:
        return self.spread(next(self._rr) % self.n_services)

    def reset(self) -> None:
        self._rr = itertools.count()


def _token(key: str) -> int:
    return int.from_bytes(hashlib.sha1(key.encode()).digest()[:8], "big")


class ConsistentHashPlacement(PlacementPolicy):
    """Virtual-node hash ring: placement is a pure function of the oid
    (stateless between puts).  Replicas walk the ring clockwise to the next
    distinct services, the classic Dynamo/Cassandra layout."""

    name = "consistent-hash"
    vnodes = 64

    def __init__(self, n_services: int, replication: int = 1):
        super().__init__(n_services, replication)
        ring = sorted(
            (_token(f"ds{i}#v{v}"), i)
            for i in range(n_services)
            for v in range(self.vnodes)
        )
        self._tokens = [t for t, _ in ring]
        self._owners = [i for _, i in ring]

    def place(self, oid: int, cls: str, group: Optional[str] = None) -> tuple[int, ...]:
        start = bisect.bisect_right(self._tokens, _token(f"oid{oid}")) % len(self._owners)
        reps: list[int] = []
        for k in range(len(self._owners)):
            ds = self._owners[(start + k) % len(self._owners)]
            if ds not in reps:
                reps.append(ds)
                if len(reps) == self.replication:
                    break
        return tuple(reps)


class LocalityAwarePlacement(PlacementPolicy):
    """Co-locate hint-tree subtrees: all objects sharing a ``group`` key
    land on one service (first-seen groups round-robin for balance, so the
    cluster stays level while each subtree stays whole).  Ungrouped objects
    fall back to plain round-robin on the same counter."""

    name = "locality"

    def __init__(self, n_services: int, replication: int = 1):
        super().__init__(n_services, replication)
        self._rr = itertools.count()
        self._groups: dict[str, int] = {}

    def place(self, oid: int, cls: str, group: Optional[str] = None) -> tuple[int, ...]:
        if group is None:
            primary = next(self._rr) % self.n_services
        else:
            primary = self._groups.get(group)
            if primary is None:
                primary = next(self._rr) % self.n_services
                self._groups[group] = primary
        return self.spread(primary)

    def reset(self) -> None:
        self._rr = itertools.count()
        self._groups.clear()


PLACEMENTS: dict[str, type[PlacementPolicy]] = {
    RoundRobinPlacement.name: RoundRobinPlacement,
    ConsistentHashPlacement.name: ConsistentHashPlacement,
    LocalityAwarePlacement.name: LocalityAwarePlacement,
}

DEFAULT_PLACEMENT = RoundRobinPlacement.name


def make_placement(name: str, n_services: int, replication: int = 1) -> PlacementPolicy:
    try:
        cls = PLACEMENTS[name]
    except KeyError:
        raise KeyError(
            f"unknown placement policy {name!r}; expected one of {sorted(PLACEMENTS)}"
        ) from None
    return cls(n_services, replication=replication)


def available_placements() -> list[str]:
    return sorted(PLACEMENTS)
