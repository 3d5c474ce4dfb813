"""What the metric readers share: the window's requests and gaps, and a
percentile."""

from __future__ import annotations

import math

import numpy as np


def in_window(rec, t: float) -> bool:
    return rec.t_open <= t < rec.t_close


def window_requests(rec) -> list:
    """The requests sent in the window (due in it)."""
    return [e for e in rec.requests if in_window(rec, e["due"])]


def gaps(rec) -> list:
    """Every gap between two consecutive tokens of one request whose later
    token came in the window, in seconds: each request's inter-token gaps,
    the stalls of admissions and of the host loop included."""
    out = []
    for e in rec.requests:
        t = e["times"]
        out.extend(b - a for a, b in zip(t, t[1:]) if in_window(rec, b))
    return out


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the closest ranks; an unanswered
    request is +inf and sorts last."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    pos = (len(v) - 1) * q / 100
    lo, hi = math.floor(pos), math.ceil(pos)
    if math.isinf(v[hi]):
        return math.inf
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


def traced_ticks(rec) -> list:
    """(kv lens of every row, busy rows, device s, flash-decode s) of each
    tick the trace holds."""
    if rec.trace is None:
        return []
    return [(*rec.ticks[j], *dev) for j, dev in sorted(rec.trace["ticks"].items())]
