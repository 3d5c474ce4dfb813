"""tpot_ms: the window's mean time per output token: the sum of the gaps
between consecutive tokens of a request that ended in the window, over
their number, so that every admission stall counts in proportion."""

from pb.stats import gaps


def read(rec):
    g = gaps(rec)
    return sum(g) / len(g) * 1e3 if g else None
