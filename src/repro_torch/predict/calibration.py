"""Single source of truth for wall-vs-virtual latency calibration.

``benchmarks/calibrate_latency.py`` fits per-app scale factors mapping the
replay engine's simulated stall deltas onto measured wall-clock deltas and
writes them to ``artifacts/predict/calibration.csv``.  This module loads
them back so the REPLAY constants can be re-expressed in *calibrated wall
seconds* — replay output reports both, and ``LatencyModel.scaled`` builds a
calibrated model for anyone replaying in wall units directly (the ROADMAP
follow-on this closes: the fitted scales previously lived only in the CSV
and every consumer re-parsed or hard-coded them).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.pos.latency import REPLAY, LatencyModel

DEFAULT_CALIBRATION_PATH = os.path.join("artifacts", "predict", "calibration.csv")


@dataclass
class Calibration:
    """Fitted simulated-seconds -> wall-seconds scale factors.  App keys
    match the evaluate catalog (``bank``, ``bank_write``, ``oo7``, ...);
    ``scale_for`` falls back to the global fit, then to 1.0 (uncalibrated:
    virtual seconds pass through unchanged)."""

    app_scales: dict[str, float] = field(default_factory=dict)
    global_scale: Optional[float] = None
    source: str = ""

    @property
    def fitted(self) -> bool:
        return bool(self.app_scales) or self.global_scale is not None

    def scale_for(self, app: str) -> float:
        scale = self.app_scales.get(app, self.global_scale)
        return scale if scale is not None else 1.0


def load_calibration(path: Optional[str] = None) -> Calibration:
    """Parse ``calibration.csv``.  A missing or unreadable file yields an
    unfitted (identity) calibration, never an error — benchmarks must run
    before the calibration artifact exists."""
    path = path or DEFAULT_CALIBRATION_PATH
    cal = Calibration(source=path)
    try:
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
    except OSError:
        return cal
    for row in rows:
        app = row.get("app", "")
        try:
            if row.get("scale_app"):
                cal.app_scales[app] = float(row["scale_app"])
            if cal.global_scale is None and row.get("scale_global"):
                cal.global_scale = float(row["scale_global"])
        except ValueError:
            continue
    return cal


def calibrated_model(app: str, base: LatencyModel = REPLAY,
                     calibration: Optional[Calibration] = None) -> LatencyModel:
    """The replay latency model re-expressed in calibrated wall seconds for
    ``app`` (slot counts untouched; see ``LatencyModel.scaled``)."""
    if calibration is None:
        calibration = load_calibration()
    return base.scaled(calibration.scale_for(app))
