"""Tracking (`ops/pose_opt.py`, three solves a tracked frame through
`models/tracking.py` `optimize_frame_pose`): kernel launches issued inside
the program's own `track.pose_lm` spans (`orb_slam2_e_tpu_torch/utils/
trace.py`, stamped on the profiler's clock) over the profiled stretch, per
frame; nothing where the program records no such span."""

from slambench.reference.trace import LAUNCH_CALLS


def read(trace):
    try:
        from orb_slam2_e_tpu_torch.utils import trace as program
    except ImportError:
        return None
    n = trace.stretch.get("frames", 0)
    iv = [(s.t0_ns / 1e3, s.t1_ns / 1e3)
          for s in program.within(trace.stretch["t0_us"] * 1e3,
                                  trace.stretch["t1_us"] * 1e3)
          if s.name == "track.pose_lm"]
    if not n or not iv:
        return None
    return trace.events.count_host_within(LAUNCH_CALLS, iv) / n
