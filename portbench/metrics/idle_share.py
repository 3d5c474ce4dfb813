"""idle_share.<traffic>: the share of the traced window in which no
operation ran on the device (torch.profiler), in %."""


def read(rec):
    if rec.trace is None or not rec.trace["window_s"]:
        return None
    return 100 * (1 - rec.trace["busy_s"] / rec.trace["window_s"])
