"""Versioned trace-event schema for ``ObjectStore.trace`` (schema v2).

The v1 trace was a bare list of oids appended by ``app_access`` — reads
only, so the replay engine could not charge the write path and mutating
workloads (``setAllTransCustomers``) were scored as if they never wrote.
v2 records typed events:

  * ``access``       — an application-path read navigation (``app_access``);
  * ``write``        — an application-path field update (``app_write``);
  * ``method_entry`` — entry into a registered method (the paper's injected
    scheduling point, recorded by ``Session.on_method_entry``).

Back-compat is explicit, not implicit: consumers that want the plain
demand-oid sequence (the markov miner's training input, accuracy sets)
call :func:`trace_oids`, and replay engines normalize arbitrary trace
shapes — bare oids, legacy ``("enter", key, oid)`` tuples, or
:class:`TraceEvent` records — through :func:`as_events`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

#: bumped whenever the recorded event vocabulary changes
TRACE_SCHEMA_VERSION = 2

ACCESS = "access"
WRITE = "write"
METHOD_ENTRY = "method_entry"

#: the demand-path kinds — events where the application touches an object
#: (and a predictor could have prefetched it)
DEMAND_KINDS = (ACCESS, WRITE)

# legacy tuple spelling used by the pre-v2 offline recorder, plus the
# canonical kind names so serialized events (``TraceEvent.to_tuple``)
# round-trip through ``as_events``
_LEGACY_KINDS = {
    "enter": METHOD_ENTRY,
    METHOD_ENTRY: METHOD_ENTRY,
    ACCESS: ACCESS,
    WRITE: WRITE,
}


@dataclass(frozen=True)
class TraceEvent:
    kind: str  # ACCESS | WRITE | METHOD_ENTRY
    oid: int
    method_key: Optional[str] = None  # METHOD_ENTRY only

    @property
    def is_demand(self) -> bool:
        return self.kind in DEMAND_KINDS

    def to_tuple(self) -> tuple:
        """Serialize to the plain-tuple wire form (JSON-friendly: strings
        and ints only).  ``as_events`` accepts the result, so a trace can be
        dumped to disk and replayed: ``as_events(ev.to_tuple() for ev in
        trace)`` round-trips exactly."""
        if self.kind == METHOD_ENTRY:
            return (self.kind, self.method_key, self.oid)
        return (self.kind, self.oid)


def access_event(oid: int) -> TraceEvent:
    return TraceEvent(ACCESS, oid)


def write_event(oid: int) -> TraceEvent:
    return TraceEvent(WRITE, oid)


def method_entry_event(method_key: str, oid: int) -> TraceEvent:
    return TraceEvent(METHOD_ENTRY, oid, method_key)


def _coerce(item) -> TraceEvent:
    if isinstance(item, TraceEvent):
        return item
    if isinstance(item, int):  # v1 bare-oid trace: every entry was a read
        return TraceEvent(ACCESS, item)
    if isinstance(item, tuple) and item and item[0] in _LEGACY_KINDS:
        kind = _LEGACY_KINDS[item[0]]
        if kind == METHOD_ENTRY:
            _, key, oid = item
            return TraceEvent(METHOD_ENTRY, oid, key)
        return TraceEvent(kind, item[1])
    raise TypeError(f"unrecognized trace entry {item!r}")


def as_events(trace: Iterable) -> list[TraceEvent]:
    """Normalize any supported trace shape to ``TraceEvent`` records."""
    return [_coerce(item) for item in trace]


def trace_oids(trace: Iterable, kinds: tuple[str, ...] = DEMAND_KINDS) -> list[int]:
    """The plain oid sequence of the demand-path events, in order — what
    v1 consumers (``Predictor.warm``, accuracy sets) operated on.  Accepts
    bare-oid lists unchanged, so pre-v2 recorded traces keep working."""
    return [ev.oid for ev in as_events(trace) if ev.kind in kinds]
