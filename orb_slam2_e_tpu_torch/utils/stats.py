"""Metrics logger and the relocalization KPI protocol (pure Python).

Copy of `orb_slam2_e_tpu/utils/stats.py`: the reference's Statistics class
(include/Statistics.h, a tab-separated metric writer with per-purpose
column headers, chrono helpers and moving averages), the per-attempt
`StatsReloc.txt` columns (reference src/Tracking.cc:178-183), and the
relocalization precision/recall protocol (reference Tracking.cc:488-525).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional


RELOC_COLUMNS = [
    # reference output/evaluation/StatsReloc.txt: KF_candidates,
    # Inliers_PnP_R, Time_PnP_R, then one [nGoodR timeR nGoodNR timeNR]
    # quadruple per attempted stage, pinned here to S1/S2/S3 so every row
    # has the same arity
    "Frame", "KF_candidates", "Inliers_PnP_R", "Time_PnP_R",
    "nGoodR_S1", "timeR_S1", "nGoodNR_S1", "timeNR_S1",
    "nGoodR_S2", "timeR_S2", "nGoodNR_S2", "timeNR_S2",
    "nGoodR_S3", "timeR_S3", "nGoodNR_S3", "timeNR_S3",
    "Stage", "Accepted",
]


class Statistics:
    """Tab-separated metric logger (reference Statistics(file))."""

    def __init__(self, path: Optional[str] = None, columns=None):
        self.path = Path(path) if path else None
        self.columns = columns or []
        self.row = {}
        self._chronos = {}
        self._sma = {}
        if self.path and self.columns:
            with open(self.path, 'w') as f:
                f.write("\t".join(self.columns) + "\n")

    def add(self, key, value):
        """Reference AddValue / AddValueFl / AddText."""
        self.row[key] = value
        self._sma.setdefault(key, []).append(
            value if isinstance(value, (int, float)) else 0.0)

    def new_line(self):
        """Flush the current row (reference NewLine)."""
        if self.path:
            with open(self.path, 'a') as f:
                f.write("\t".join(str(self.row.get(c, "")) for c in
                                  (self.columns or self.row.keys())) + "\n")
        self.row = {}

    def start_chrono(self, name):
        self._chronos[name] = time.perf_counter()

    def stop_chrono(self, name):
        dt = time.perf_counter() - self._chronos.pop(name, time.perf_counter())
        self.add(name, round(dt, 6))
        return dt

    def sma(self, key, window: int = 10):
        vals = self._sma.get(key, [])[-window:]
        return sum(vals) / len(vals) if vals else 0.0


class RelocKpi:
    """Relocalization precision/recall protocol: after a successful
    relocalization, a track held for `n_precision_frames` counts as TP;
    losing it earlier is FP; a failed attempt is FN.
    Pr = TP/(TP+FP); Rc = TP/(TP+FN)."""

    def __init__(self, n_precision_frames: int = 2):
        self.n_precision = n_precision_frames
        self.tp = 0
        self.fp = 0
        self.fn = 0
        self._pending = None   # frame id of the last successful reloc

    def on_reloc_success(self, frame_id: int):
        self._pending = frame_id

    def on_reloc_fail(self):
        self.fn += 1

    def on_frame_tracked(self, frame_id: int) -> bool:
        """True when this frame registers a TP; the reference forces
        bOK = false exactly then under bTestAllFrames (Tracking.cc:497-501)."""
        if self._pending is not None and \
                frame_id - self._pending >= self.n_precision:
            self.tp += 1
            self._pending = None
            return True
        return False

    def on_frame_lost(self, frame_id: int):
        if self._pending is not None:
            self.fp += 1
            self._pending = None

    @property
    def precision(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0

    @property
    def recall(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0
