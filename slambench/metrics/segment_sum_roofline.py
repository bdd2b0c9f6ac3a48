"""Kernels (`csrc/segment_sum.cu`): the share of the kernel's device time
over the profiled stretch that the least time of its launches fills: the
bound of each call from its segments, columns and live rows (bytes at
3.35e12 B/s, adds at the float32 peak; `reference/roofline.py`), in %."""


def read(trace):
    dev = trace.events.kernel_seconds("segment_sum_kernel")
    bounds = trace.segment_sum_bounds_s
    if not dev or not bounds or len(dev) != len(bounds):
        return None
    return 100.0 * sum(bounds) / sum(dev)
