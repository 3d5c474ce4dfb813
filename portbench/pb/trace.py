"""The traced run's device timeline: ``torch.profiler`` over part of the
window, reduced to what the per-layer readers take.

The harness marks its own spans with ``record_function``: ``pb.admit.<i>``
around admission i, ``pb.tick.<j>`` around tick j (the replay and the read
of its tokens), ``pb.step`` around an engine step and ``pb.wait`` where
the open loop sleeps until the next arrival.  An admission and a tick each
end in a read that waits for the device, so the kernels that run inside a
span's interval are the span's.  Times are the profiler's (ns on one clock
for host and device).
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict

import torch

DECODE_KERNEL = re.compile(r"decode_(mma|split|merge)_kernel")


def span(name: str):
    return torch.profiler.record_function(name)


class Tracer:
    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.t0 = self.t1 = None

    def start(self):
        self.prof.start()
        self.t0 = time.time_ns()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.stop()

    def reduce(self) -> dict:
        return reduce(self.prof.profiler.kineto_results.events(), self.t0, self.t1)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Intervals:
    """Sorted intervals (disjoint, or at least sorted by start and by end
    alike), searched by bisection."""

    def __init__(self, ivs):
        self.ivs = sorted(ivs)
        self.starts = [a for a, _ in self.ivs]

    def covered(self, a: int, b: int) -> int:
        """ns of [a, b] that the intervals cover (counted once each)."""
        i = max(0, bisect.bisect_right(self.starts, a) - 1)
        n = 0
        while i < len(self.ivs) and self.ivs[i][0] < b:
            x, y = self.ivs[i]
            n += max(0, min(b, y) - max(a, x))
            i += 1
        return n

    def holds(self, t: int) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t < self.ivs[i][1]


def reduce(events, t0: int, t1: int) -> dict:
    """From profiler events: the window's length and busy seconds, each
    traced admission's and tick's device-busy seconds (ticks also their
    flash-decode kernels' seconds), the ten device operations that took
    most time and the idle time by what the host was doing."""
    kernels, spans = [], defaultdict(list)
    for e in events:
        a = e.start_ns()
        b = a + e.duration_ns()
        name = e.name()
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        if name.startswith("pb."):
            if not on_device:  # the profiler mirrors each span on the device's timeline too
                spans[name].append((a, b))
        elif on_device:
            a, b = max(a, t0), min(b, t1)
            if b > a:
                kernels.append((a, b, name))
    merged = _merge([(a, b) for a, b, _ in kernels])
    busy = sum(b - a for a, b in merged)
    device = _Intervals(merged)
    by_name = defaultdict(int)
    for a, b, n in kernels:
        by_name[n] += b - a
    # one stream: the flash-decode kernels run one after another
    decode = _Intervals([(a, b) for a, b, n in kernels if DECODE_KERNEL.search(n)])
    admits, ticks = {}, {}
    kinds = defaultdict(list)
    for name, ivs in spans.items():
        parts = name.split(".")
        kinds[parts[1]].extend(ivs)
        if len(parts) == 3 and parts[1] in ("admit", "tick"):
            a, b = ivs[0]
            if a < t0 or b > t1:
                continue
            dev = device.covered(a, b) / 1e9
            if parts[1] == "admit":
                admits[int(parts[2])] = dev
            else:
                ticks[int(parts[2])] = (dev, decode.covered(a, b) / 1e9)
    where = {k: _Intervals(kinds[k]) for k in ("admit", "tick", "wait", "step")}
    idle = defaultdict(int)
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            mid = (a + b) // 2
            kind = next((f"pb.{k}" for k, ivs in where.items() if ivs.holds(mid)), "host")
            idle[kind] += b - a
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (t1 - t0) / 1e9,
        "busy_s": busy / 1e9,
        "admits": admits,
        "ticks": ticks,
        "device_ops": [[n, s / 1e9] for n, s in top],
        "idle_gaps": [[n, s / 1e9] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])][:10],
    }
