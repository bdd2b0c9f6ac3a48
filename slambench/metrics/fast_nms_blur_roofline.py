"""Kernels (`csrc/fast_nms_blur.cu`): the share of the kernel's device time
over the profiled stretch that the least time of its launches fills: the
bound of each launch from the pixels of its levels and the early-reject
and score counts the plain reference takes of them (bytes at 3.35e12 B/s,
operations at the float32 peak; `reference/roofline.py`), in %."""


def read(trace):
    dev = trace.events.kernel_seconds("fast_nms_blur_kernel")
    bounds = trace.fast_nms_blur_bounds_s
    if not dev or not bounds or len(dev) != len(bounds):
        return None
    return 100.0 * sum(bounds) / sum(dev)
