"""prefill_mfu.code: the FLOPs the traced admissions' prompts need (a
batch-1 prefill: pb/work.py) over their device-busy time at the peak
FLOP/s, in %."""

from pb import work


def read(rec):
    if rec.trace is None:
        return None
    flops = dev = 0.0
    for i, dev_s in rec.trace["admits"].items():
        flops += work.prefill_flops(rec.cfg, rec.admissions[i][2])
        dev += dev_s
    return 100 * flops / (work.PEAK_FLOPS * dev) if dev else None
