"""ttft_p50_ms: the median, over every request sent in the window, of the
time from when it fell due to its first token, in ms; a request never
answered counts as infinite."""

import math

from pb.stats import percentile, window_requests


def read(rec):
    ttft = [e["times"][0] - e["due"] if e["times"] else math.inf for e in window_requests(rec)]
    return percentile(ttft, 50) * 1e3 if ttft else None
