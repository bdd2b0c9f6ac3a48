"""Kernels (`csrc/segment_sum.cu`): the share of the kernel's device time
that the least time of its launches fills, over the window's first three
mapping passes of a traced run, each profiled in a session of its own
(`traffic/stream.py` `CAPTURES`). They are the same keyframes' passes
whatever the port's speed, where the profiled stretch after the window
holds a mapping pass only by chance. The bound of each call from its
segments, columns and live rows (bytes at 3.35e12 B/s, adds at the float32
peak; `reference/roofline.py`), in %; nothing where a session's launches
and recorded calls differ in number, or where none launched."""


def read(trace):
    dev, bounds = [], []
    for events, b in trace.captures:
        d = events.kernel_seconds("segment_sum_kernel")
        if len(d) != len(b):
            return None
        dev += d
        bounds += b
    if not dev:
        return None
    return 100.0 * sum(bounds) / sum(dev)
