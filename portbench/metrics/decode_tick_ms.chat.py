"""decode_tick_ms.chat: the host time of the window's engine steps that
admitted nothing (a replay of the captured tick and the read of its
tokens), over their number, in ms."""

from pb.stats import in_window


def read(rec):
    d = [t1 - t0 for t0, t1, n in rec.steps if n == 0 and in_window(rec, t0)]
    return sum(d) / len(d) * 1e3 if d else None
