"""Frame loop (`models/system.py`): synchronizing CUDA calls that the
program makes outside its explicit host reads: those inside one of its root
spans (`frame`, `rectify`; `orb_slam2_e_tpu_torch/utils/trace.py`, stamped
on the profiler's clock) and outside every `wait.*` span, over the profiled
stretch, per frame: `.item()`-like reads, boolean-mask indexing, host
scalars copied to the device. Nothing where the program records no span."""

import bisect

from slambench.reference.trace import SYNC_CALLS, union


def _inside(starts, iv, t):
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= iv[i][1]


def read(trace):
    try:
        from orb_slam2_e_tpu_torch.utils import trace as program
    except ImportError:
        return None
    n = trace.stretch.get("frames", 0)
    recs = program.within(trace.stretch["t0_us"] * 1e3,
                          trace.stretch["t1_us"] * 1e3)
    roots = union((s.t0_ns / 1e3, s.t1_ns / 1e3) for s in recs
                  if s.parent < 0)
    waits = union((s.t0_ns / 1e3, s.t1_ns / 1e3) for s in recs
                  if s.name.startswith("wait."))
    if not n or not roots:
        return None
    r0, w0 = [s for s, _ in roots], [s for s, _ in waits]
    k = sum(1 for name, s, _ in trace.events.host if name in SYNC_CALLS
            and _inside(r0, roots, s) and not _inside(w0, waits, s))
    return k / n
