"""Loop closing (`models/loop_closing.py`, `models/kf_database.py`,
`ops/bow.py`, `ops/sim3_solve.py`): ms of the synchronized spans around
the loop query (`_loop_dispatch`), its harvest (`_loop_harvest`) and the
global-BA chunks (`_advance_gba`) that had work, over the traced window,
per keyframe inserted; nothing where none was."""


def read(trace):
    kf = len(trace.spans.get("map", []))
    if not kf:
        return None
    loop = trace.spans.get("loop")
    return sum(loop) / kf if loop else None
