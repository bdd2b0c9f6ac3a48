"""Mapping (`models/local_mapping.py` `local_ba`, `ops/ba.py`,
`ops/scatter.py`): host ms of the program's own `map.local_ba` spans over
the profiled stretch, per `map` span (a keyframe inserted with its mapping
pass; `orb_slam2_e_tpu_torch/utils/trace.py`); nothing where the stretch
inserted no keyframe or the program records no such span. The profiler
slows the host, so this reads above an unprofiled local BA."""


def read(trace):
    try:
        from orb_slam2_e_tpu_torch.utils import trace as program
    except ImportError:
        return None
    recs = program.within(trace.stretch["t0_us"] * 1e3,
                          trace.stretch["t1_us"] * 1e3)
    kf = sum(1 for s in recs if s.name == "map")
    if not kf:
        return None
    return sum((s.t1_ns - s.t0_ns) / 1e6 for s in recs
               if s.name == "map.local_ba") / kf
