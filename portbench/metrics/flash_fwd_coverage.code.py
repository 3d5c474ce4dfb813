"""flash_fwd_coverage.code: the share of the window's prefill attention
FLOPs that ran in the flash forward kernel (an admission that launched
it, by the kernel's launch counter), in %."""

from pb import work
from pb.stats import in_window


def read(rec):
    done = [(S, flash) for t0, _, S, flash in rec.admissions if in_window(rec, t0) and flash is not None]
    total = sum(work.prefill_attn_flops(rec.cfg, S) for S, _ in done)
    flash = sum(work.prefill_attn_flops(rec.cfg, S) for S, n in done if n)
    return 100 * flash / total if total else None
