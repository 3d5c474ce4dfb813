"""The kernel wrappers' launch counters, read and moved together.

Each wrapper adds one to its counts (``launches``; flash-decode also
``launches_mma`` or ``launches_simt``) where it launches its kernel, and
nowhere else.  A replay of a CUDA graph launches the captured kernels
without running any wrapper, while the capture ran the wrappers and
launched nothing.  So whoever captures and replays a graph
(``launch.steps.CapturedDecode``) takes ``snapshot()`` before the capture,
``delta = since(before)`` after it, takes the capture's counts back with
``add(delta, -1)`` and adds ``add(delta)`` on every replay: the counters
then read what was launched, as they do on the eager path.
"""

from __future__ import annotations

from .decode_attention import decode_attention_fwd
from .flash_attention import flash_attention_fwd
from .flash_attention_bwd import flash_attention_bwd_dkdv, flash_attention_bwd_dq
from .mamba_scan import mamba_scan_fwd
from .prefetch_gather import prefetch_gather_fwd
from .rglru_scan import rglru_gated_fwd, rglru_scan_fwd
from .selective_scan import selective_scan_fwd

WRAPPERS = (flash_attention_fwd, flash_attention_bwd_dkdv, flash_attention_bwd_dq,
            decode_attention_fwd, prefetch_gather_fwd, mamba_scan_fwd, rglru_scan_fwd,
            selective_scan_fwd, rglru_gated_fwd)
ATTRS = ("launches", "launches_mma", "launches_simt")


def snapshot() -> dict:
    """{(wrapper, counter name): count} of every counter of every wrapper."""
    return {(fn, a): getattr(fn, a) for fn in WRAPPERS for a in ATTRS if hasattr(fn, a)}


def since(before: dict) -> dict:
    """The counters that moved since ``before`` (a ``snapshot()``), with how
    far."""
    now = snapshot()
    return {key: now[key] - n for key, n in before.items() if now[key] != n}


def add(delta: dict, times: int = 1) -> None:
    """Add ``times`` times ``delta`` (a ``since()``) to the counters."""
    for (fn, a), n in delta.items():
        setattr(fn, a, getattr(fn, a) + times * n)
