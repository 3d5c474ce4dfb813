"""tokens_per_s: the output tokens served in the window over its seconds."""

from pb.stats import in_window


def read(rec):
    n = sum(1 for e in rec.requests for t in e["times"] if in_window(rec, t))
    return n / (rec.t_close - rec.t_open)
