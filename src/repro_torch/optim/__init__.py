"""AdamW with global-norm clipping and the warmup-cosine schedule.
Counterpart of ``repro.optim`` (``adamw``, ``schedule``)."""

from .adamw import AdamW, clip_by_global_norm  # noqa: F401
from .schedule import warmup_cosine  # noqa: F401
