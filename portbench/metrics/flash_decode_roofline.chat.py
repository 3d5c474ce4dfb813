"""flash_decode_roofline.chat: the bytes the traced ticks' flash-decode
calls need (q, o, and each row's keys and values up to its kv_len, one
call a layer: pb/work.py) over the decode kernels' device time at the peak
bytes/s, in %."""

from pb import work
from pb.stats import traced_ticks


def read(rec):
    nbytes = dev = 0.0
    for lens, _, _, dec_s in traced_ticks(rec):
        nbytes += rec.cfg["n_layers"] * work.decode_attention_bytes(rec.cfg, lens)
        dev += dec_s
    return 100 * nbytes / (work.PEAK_BYTES * dev) if dev else None
