"""Device: kernels run on the card per frame over the profiled stretch
(a lane-frame counting as a frame)."""


def read(trace):
    n = trace.stretch.get("frames", 0)
    return len(trace.events.kernels()) / n if n else None
