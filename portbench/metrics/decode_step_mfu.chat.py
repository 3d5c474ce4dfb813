"""decode_step_mfu.chat: the traced ticks' roofline bound, max(FLOPs / peak
FLOP/s, bytes / peak bytes/s) of the work the busy rows need (pb/work.py),
over the ticks' device-busy time, in %."""

from pb import work
from pb.stats import traced_ticks


def read(rec):
    bound = dev = 0.0
    for lens, busy, dev_s, _ in traced_ticks(rec):
        kv = [n for n, b in zip(lens, busy) if b]
        if not kv:
            continue
        flops, nbytes = work.tick_work(rec.cfg, kv)
        bound += max(flops / work.PEAK_FLOPS, nbytes / work.PEAK_BYTES)
        dev += dev_s
    return 100 * bound / dev if dev else None
