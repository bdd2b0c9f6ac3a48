"""Device (H100): the share of the profiled stretch's wall time in which
no operation ran on the card (one minus the union of the device
intervals), in %. The profiler slows the host, so this reads higher than
an untraced frame's idle share would."""


def read(trace):
    wall = trace.stretch.get("wall_s", 0.0)
    if wall <= 0:
        return None
    return 100.0 * (1.0 - trace.events.busy_us() * 1e-6 / wall)
