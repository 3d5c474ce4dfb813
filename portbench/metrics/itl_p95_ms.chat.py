"""itl_p95_ms.chat: the 95th percentile of the gaps between consecutive
tokens of a request that ended in the window, in ms."""

from pb.stats import gaps, percentile


def read(rec):
    g = gaps(rec)
    return percentile(g, 95) * 1e3 if g else None
