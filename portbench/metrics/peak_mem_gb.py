"""peak_mem_gb: torch.cuda.max_memory_allocated() over set-up and window, in GB."""


def read(rec):
    return rec.peak_bytes / 1e9 if rec.peak_bytes else None
