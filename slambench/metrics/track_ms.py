"""Tracking (`models/tracking.py`, `ops/matching.py`, `ops/pose_opt.py`):
median ms of a synchronized span around `tracking.track_frame_fused`, or
around the vmapped step of all lanes, over the traced window."""

import statistics


def read(trace):
    v = trace.spans.get("track")
    return statistics.median(v) if v else None
