"""Mapping (insertion in `models/tracking.py`, `models/local_mapping.py`,
`ops/ba.py`, `ops/scatter.py`): ms of the synchronized spans around the
insertion and mapping pass (`SlamSystem._super_insert`) over the traced
window, per keyframe inserted; nothing where none was."""


def read(trace):
    v = trace.spans.get("map")
    return sum(v) / len(v) if v else None
