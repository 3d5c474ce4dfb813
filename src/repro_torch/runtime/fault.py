"""Fault-tolerance machinery of the training loop.  Counterpart of
``repro.runtime.fault``: so far only ``StragglerDetector``, an own copy
(the port imports nothing of the JAX package).  The heartbeat monitor, the
elastic planner and the supervisor wait for the multi-device slice
(ROADMAP.md, section 1, item 6).
"""

from __future__ import annotations


class StragglerDetector:
    """Robust per-node step-duration outlier detection (median + MAD)."""

    def __init__(self, threshold: float = 4.0, min_samples: int = 5, patience: int = 3):
        self.threshold = threshold
        self.min_samples = min_samples
        self.patience = patience
        self._durations: dict = {}
        self._strikes: dict = {}

    def record(self, node_id, seconds: float) -> None:
        self._durations.setdefault(node_id, []).append(seconds)

    def check(self) -> list:
        """Nodes whose last step is a persistent outlier."""
        lasts = {n: d[-1] for n, d in self._durations.items() if d}
        if len(lasts) < self.min_samples:
            return []
        vals = sorted(lasts.values())
        med = vals[len(vals) // 2]
        mad = sorted(abs(v - med) for v in vals)[len(vals) // 2] or 1e-9
        out = []
        for n, v in lasts.items():
            if (v - med) / (1.4826 * mad) > self.threshold:
                self._strikes[n] = self._strikes.get(n, 0) + 1
                if self._strikes[n] >= self.patience:
                    out.append(n)
            else:
                self._strikes[n] = 0
        return out
