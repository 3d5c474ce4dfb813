"""admit_ms.chat: the mean admission (ContinuousBatcher._admit_one: the
batch-1 prefill, the slot's cache rows and the first token, ended by the
read of that token) of the window, in ms."""

from pb.stats import in_window


def read(rec):
    d = [t1 - t0 for t0, t1, _, _ in rec.admissions if in_window(rec, t0)]
    return sum(d) / len(d) * 1e3 if d else None
