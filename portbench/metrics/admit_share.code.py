"""admit_share.code: the share of the window spent in admissions, in %."""


def read(rec):
    a, b = rec.t_open, rec.t_close
    busy = sum(max(0.0, min(b, t1) - max(a, t0)) for t0, t1, _, _ in rec.admissions)
    return 100 * busy / (b - a)
