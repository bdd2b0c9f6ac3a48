"""Tracking: kernel launches issued inside the tracking span, per frame
(a lane-frame counting as a frame), over the profiled stretch."""

from slambench.reference.trace import LAUNCH_CALLS


def read(trace):
    n = trace.stretch.get("frames", 0)
    spans = trace.events.spans("track")
    if not n or not spans:
        return None
    return trace.events.count_host_within(LAUNCH_CALLS, spans) / n
