"""Frame loop (`models/system.py`): synchronizing CUDA calls per frame
(`cudaStreamSynchronize`, `cudaDeviceSynchronize`, `cudaEventSynchronize`)
over the profiled stretch, a lane-frame counting as a frame."""

from slambench.reference.trace import SYNC_CALLS


def read(trace):
    n = trace.stretch.get("frames", 0)
    return trace.events.count_host(SYNC_CALLS) / n if n else None
