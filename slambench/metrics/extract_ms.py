"""Extraction (`ops/orb.py`, `ops/kernels.py`, `models/frame.py`,
`ops/stereo.py`): median ms of a synchronized span around the frame build
(`SlamSystem._make_frame_inputs`, or `OrbExtractor.extract_batch` of all
lanes) over the traced window."""

import statistics


def read(trace):
    v = trace.spans.get("extract")
    return statistics.median(v) if v else None
