"""Chrome-trace / Perfetto JSON export of prefetch lifecycle spans.

The exported object follows the Chrome Trace Event format (the JSON flavour
Perfetto's UI at https://ui.perfetto.dev opens directly):

  * one **process track per Data Service** (pid = service id), one thread
    track per batch lane (tid), plus a dedicated demand-path track;
  * each span renders as a chain of ``"X"`` (complete) slices — one per
    lifecycle phase: ``predicted`` (prediction → dispatch), ``dispatch``
    (dispatch → claim), ``lane_wait`` (claim → chunk pickup), ``slot_wait``
    (chunk pickup → disk slot acquired) and ``disk`` (slot service time) —
    so a prefetched oid shows >= 4 phases end to end;
  * the terminal outcome is an ``"i"`` (instant) event carrying the
    hidden/stalled attribution in ``args``;
  * every prefetch span that reached its demand use also emits a **flow
    arrow** (``"s"`` → ``"t"`` → ``"f"``, one shared numeric ``id`` per
    span): prediction → load landing → demand hit, so Perfetto draws the
    causal chain across tracks instead of leaving three disjoint slices;
  * ``"C"`` (counter) tracks derive disk-slot occupancy per service and a
    demand-queue depth from the spans themselves, so the demand-priority
    handoffs are visible without extra hooks.

Wall-clock runs pass ``perf_counter`` timestamps (normalized so the trace
starts at ts=0); virtual-clock replays pass virtual seconds, which map 1:1
to trace microseconds — the same exporter serves both stacks.
"""

from __future__ import annotations

import json
from typing import Iterable, Optional, Sequence

from .spans import PrefetchSpan

#: ordered (phase name, start attr, end attr) — the span's renderable slices
PHASE_EDGES = (
    ("predicted", "predicted_t", "dispatched_t"),
    ("dispatch", "dispatched_t", "claimed_t"),
    ("lane_wait", "claimed_t", "queued_t"),
    ("slot_wait", "queued_t", "load_start_t"),
    ("disk", "load_start_t", "load_done_t"),
)

_DEMAND_TID = 9999  # dedicated per-service demand-path track


def _us(t: float, t0: float) -> float:
    return max(0.0, (t - t0) * 1e6)


def chrome_trace(spans: Sequence[PrefetchSpan], *, clock: str = "wall",
                 counters: bool = True,
                 instants: Sequence[dict] = (),
                 process_names: Optional[dict] = None) -> dict:
    """Serialize spans to a Chrome-trace JSON object.

    ``clock`` is recorded in trace metadata ("wall" | "virtual"); virtual
    traces already start near 0, wall traces are normalized to the earliest
    timestamp so Perfetto doesn't render hours of empty lead-in.

    ``instants`` are ``Tracer.instants()`` markers (failover / crash /
    demand-steal) rendered as process-scoped instant events on their
    service's track.  ``process_names`` overrides per-pid track labels —
    how non-store producers (e.g. the weight streamer at its own pid)
    share one timeline with the Data Services.
    """
    ts_all = [t for s in spans
              for t in (s.predicted_t, s.load_done_t, s.outcome_t)
              if t is not None]
    ts_all.extend(i["t"] for i in instants)
    t0 = min(ts_all) if ts_all else 0.0
    if clock == "virtual":
        t0 = 0.0

    events: list[dict] = []
    services: set[int] = set()
    lanes: set[tuple[int, int]] = set()

    for flow_id, span in enumerate(spans):
        pid = max(span.service, 0)
        services.add(pid)
        tid = _DEMAND_TID if span.kind == "demand" else max(span.lane, 0)
        lanes.add((pid, tid))
        name = f"oid {span.oid}"
        args = {
            "oid": span.oid,
            "kind": span.kind,
            "origin": span.origin,
            "batch_id": span.batch_id,
            "outcome": span.outcome,
            "session": span.session,
        }
        for phase, a, b in PHASE_EDGES:
            ta, tb = getattr(span, a), getattr(span, b)
            if ta is None or tb is None:
                continue
            events.append({
                "name": f"{phase}:{name}" if phase != "disk" else name,
                "cat": f"{span.kind},{phase}",
                "ph": "X",
                "ts": _us(ta, t0),
                "dur": max(0.0, (tb - ta) * 1e6),
                "pid": pid,
                "tid": tid,
                "args": args,
            })
        if span.outcome and span.outcome_t is not None:
            events.append({
                "name": f"{span.outcome}:{name}",
                "cat": f"{span.kind},outcome",
                "ph": "i",
                "s": "t",
                "ts": _us(span.outcome_t, t0),
                "pid": pid,
                "tid": tid,
                "args": {**args, "hidden_s": span.hidden_s,
                         "stall_s": span.stall_s,
                         "re_predicted": span.re_predicted},
            })
        # flow arrow prediction -> load landing -> demand use: only spans
        # whose prefetch actually met a demand access get one (hit/partial);
        # the three events share this span's numeric id, which is what
        # Perfetto keys the arrow rendering on
        if (span.kind == "prefetch" and span.outcome in ("hit", "partial")
                and span.predicted_t is not None and span.outcome_t is not None):
            flow = {"name": name, "cat": "prefetch,flow", "id": flow_id,
                    "pid": pid, "tid": tid}
            events.append({**flow, "ph": "s",
                           "ts": _us(span.predicted_t, t0)})
            if span.load_done_t is not None:
                events.append({**flow, "ph": "t",
                               "ts": _us(span.load_done_t, t0)})
            events.append({**flow, "ph": "f", "bp": "e",
                           "ts": _us(span.outcome_t, t0)})

    for marker in instants:
        pid = max(int(marker.get("service", -1)), 0)
        services.add(pid)
        events.append({
            "name": marker["name"],
            "cat": "fault",
            "ph": "i",
            "s": "p",  # process-scoped: the whole service track flags it
            "ts": _us(marker["t"], t0),
            "pid": pid,
            "tid": 0,
            "args": dict(marker.get("args", {})),
        })

    if counters:
        events.extend(_occupancy_counters(spans, t0))

    # metadata: readable process/thread names in the Perfetto track list
    names = process_names or {}
    for pid in sorted(services):
        events.append({"name": "process_name", "ph": "M", "ts": 0.0,
                       "pid": pid, "tid": 0,
                       "args": {"name": names.get(pid, f"data-service {pid}")}})
    for pid, tid in sorted(lanes):
        label = "demand path" if tid == _DEMAND_TID else f"lane {tid}"
        events.append({"name": "thread_name", "ph": "M", "ts": 0.0,
                       "pid": pid, "tid": tid, "args": {"name": label}})

    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"clock": clock, "spans": len(spans)},
    }


def _occupancy_counters(spans: Sequence[PrefetchSpan], t0: float) -> list[dict]:
    """Derive disk-slot occupancy (per service) and demand-queue depth
    counter tracks from span edges: +1 when a load enters the disk, -1 when
    it lands; demand depth spans the stall window of each demand access."""
    deltas: dict[tuple[int, str], list[tuple[float, int]]] = {}

    def edge(pid: int, track: str, t: float, d: int) -> None:
        deltas.setdefault((pid, track), []).append((t, d))

    for span in spans:
        pid = max(span.service, 0)
        if span.load_start_t is not None and span.load_done_t is not None:
            edge(pid, "disk_busy", span.load_start_t, +1)
            edge(pid, "disk_busy", span.load_done_t, -1)
        if span.kind == "demand" or span.stall_s > 0:
            start = span.predicted_t if span.kind == "demand" else span.outcome_t
            if start is not None and span.outcome_t is not None:
                begin = min(start, span.outcome_t)
                end = max(begin, span.outcome_t) if span.kind == "demand" \
                    else begin + span.stall_s
                edge(pid, "demand_queue", begin, +1)
                edge(pid, "demand_queue", end, -1)

    events: list[dict] = []
    for (pid, track), edges in sorted(deltas.items()):
        edges.sort(key=lambda e: e[0])
        level = 0
        for t, d in edges:
            level += d
            events.append({
                "name": track, "ph": "C", "ts": _us(t, t0),
                "pid": pid, "tid": 0, "args": {track: max(0, level)},
            })
    return events


def validate_chrome_trace(obj) -> list[str]:
    """Schema check for an exported trace object.  Returns human-readable
    problems (empty list = valid): traceEvents must be a list of events each
    carrying name/ph/ts/pid/tid, ts >= 0, "X" events a non-negative dur,
    and the whole object must be JSON-serializable."""
    problems: list[str] = []
    if not isinstance(obj, dict):
        return ["trace is not a JSON object"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    try:
        json.dumps(obj)
    except (TypeError, ValueError) as exc:
        problems.append(f"not JSON-serializable: {exc}")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i}: missing {key!r}")
        ts = ev.get("ts")
        if isinstance(ts, (int, float)) and ts < 0:
            problems.append(f"event {i}: negative ts {ts}")
        if ev.get("ph") == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: X event with bad dur {dur!r}")
        if ev.get("ph") in ("s", "t", "f") and not isinstance(ev.get("id"), int):
            problems.append(
                f"event {i}: flow event ({ev.get('ph')}) without a numeric id")
        if len(problems) > 20:
            problems.append("... (truncated)")
            break
    return problems


def validate_flow_pairing(obj) -> list[str]:
    """Flow-arrow consistency: every flow id must open with an ``"s"``,
    close with at most one ``"f"``, and run monotone in time — a dangling
    ``"t"``/``"f"`` renders as an arrow from nowhere in Perfetto."""
    problems: list[str] = []
    flows: dict[int, dict[str, list[float]]] = {}
    for ev in obj.get("traceEvents", []):
        ph = ev.get("ph")
        if ph not in ("s", "t", "f"):
            continue
        by_ph = flows.setdefault(ev.get("id"), {"s": [], "t": [], "f": []})
        by_ph[ph].append(ev.get("ts", 0.0))
    for fid, by_ph in sorted(flows.items(), key=lambda kv: (kv[0] is None, kv[0])):
        if len(by_ph["s"]) != 1:
            problems.append(f"flow {fid}: {len(by_ph['s'])} start events (want 1)")
            continue
        if len(by_ph["f"]) > 1:
            problems.append(f"flow {fid}: {len(by_ph['f'])} finish events (want <= 1)")
        chain = by_ph["s"] + sorted(by_ph["t"]) + by_ph["f"]
        if any(b < a for a, b in zip(chain, chain[1:])):
            problems.append(f"flow {fid}: non-monotone timestamps {chain}")
    return problems


def full_lifecycle_phase_counts(obj) -> dict[int, int]:
    """oid -> number of distinct lifecycle phases present in the trace —
    the acceptance check that every prefetched oid renders >= 4 phases."""
    phases: dict[int, set] = {}
    for ev in obj.get("traceEvents", []):
        cat = ev.get("cat", "")
        if ev.get("ph") != "X" or not cat.startswith("prefetch"):
            continue
        oid = ev.get("args", {}).get("oid")
        if oid is None:
            continue
        phases.setdefault(oid, set()).add(cat.split(",", 1)[-1])
    return {oid: len(ps) for oid, ps in phases.items()}


def write_chrome_trace(path, spans: Sequence[PrefetchSpan], *,
                       clock: str = "wall", counters: bool = True,
                       instants: Sequence[dict] = (),
                       process_names: Optional[dict] = None) -> dict:
    """Export + validate + write in one step; raises on schema violations
    so a benchmark can't silently publish a broken timeline."""
    trace = chrome_trace(spans, clock=clock, counters=counters,
                         instants=instants, process_names=process_names)
    problems = validate_chrome_trace(trace) + validate_flow_pairing(trace)
    if problems:
        raise ValueError(f"invalid chrome trace: {problems[:5]}")
    with open(path, "w") as fh:
        json.dump(trace, fh)
    return trace
