"""Frame loop (`models/system.py`, `models/local_mapping.py`): host ms
spent inside the program's own `wait.*` spans, each around one explicit read
of the device's results on the host (the super-step's predicate, the
frames' flags, the keyframe-culling reads, ...;
`orb_slam2_e_tpu_torch/utils/trace.py`), over the profiled stretch, per
frame; nested waits count once. Nothing where the program records no such
span."""

from slambench.reference.trace import union_length


def read(trace):
    try:
        from orb_slam2_e_tpu_torch.utils import trace as program
    except ImportError:
        return None
    n = trace.stretch.get("frames", 0)
    iv = [(s.t0_ns, s.t1_ns)
          for s in program.within(trace.stretch["t0_us"] * 1e3,
                                  trace.stretch["t1_us"] * 1e3)
          if s.name.startswith("wait.")]
    if not n or not iv:
        return None
    return union_length(iv) / 1e6 / n
