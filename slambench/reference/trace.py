"""Arithmetic on a `torch.profiler` trace, read from its raw kineto events
(building the profiler's own event tree costs tens of seconds for a stretch
of frames that issue tens of thousands of launches).

Copied from the program's profiling tool
(`orb_slam2_e_tpu_torch/tools/profile_step.py`: `_union_us`, `SYNC_CALLS`,
the event filter of `profile_frames`).
"""

from __future__ import annotations

import bisect

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")
SPAN_PREFIX = "slambench."


def union(intervals):
    """The merged, sorted union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_length(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


class Events:
    """The events of one profiled stretch, times in microseconds:
    `device` [(name, start, end)] (kernels, copies, sets), `host`
    [(name, start, end)] (every CPU-side event: operators, runtime calls,
    the benchmark's own `slambench.*` ranges)."""

    def __init__(self, device, host):
        self.device = device
        self.host = host

    @staticmethod
    def from_profiler(prof) -> "Events":
        import torch
        device, host = [], []
        for ev in prof.profiler.kineto_results.events():
            if getattr(ev, "is_hidden_event", lambda: False)():
                continue
            row = (ev.name(), ev.start_ns() / 1e3, ev.end_ns() / 1e3)
            if ev.device_type() == torch.autograd.DeviceType.CPU:
                host.append(row)
            elif not row[0].startswith(SPAN_PREFIX):
                # the profiler mirrors each host range onto the device's
                # timeline; those are no device work
                device.append(row)
        return Events(device, host)

    def kernels(self):
        return [e for e in self.device
                if not e[0].startswith(("Memcpy", "Memset"))]

    def busy_us(self) -> float:
        return union_length([(s, e) for _, s, e in self.device])

    def count_host(self, names) -> int:
        return sum(1 for n, _, _ in self.host if n in names)

    def spans(self, name: str):
        """Intervals of the benchmark's range `slambench.<name>`."""
        full = SPAN_PREFIX + name
        return [(s, e) for n, s, e in self.host if n == full]

    def count_host_within(self, names, intervals) -> int:
        """Host events named in `names` that start inside one of
        `intervals`."""
        iv = union(intervals)
        starts = [s for s, _ in iv]
        k = 0
        for n, s, _ in self.host:
            if n in names:
                i = bisect.bisect_right(starts, s) - 1
                if i >= 0 and s <= iv[i][1]:
                    k += 1
        return k

    def kernel_seconds(self, substring: str):
        """Device seconds of each launch of the kernels whose name holds
        `substring`, in launch order."""
        return [(e - s) * 1e-6 for n, s, e in sorted(self.kernels(),
                                                     key=lambda r: r[1])
                if substring in n]

    def top_device_ops(self, k: int = 10):
        tot = {}
        for n, s, e in self.device:
            tot[n] = tot.get(n, 0.0) + (e - s) * 1e-6
        return sorted(([n, v] for n, v in tot.items()),
                      key=lambda r: -r[1])[:k]

    def idle_gaps(self, t0: float, t1: float, k: int = 10):
        """The k longest stretches of [t0, t1] in which nothing ran on the
        device, each named by the benchmark range and the innermost host
        event the host was in when it began."""
        busy = union([(max(s, t0), min(e, t1)) for _, s, e in self.device
                      if e > t0 and s < t1])
        gaps, cur = [], t0
        for s, e in busy:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if t1 > cur:
            gaps.append((cur, t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for gs, ge in gaps[:k]:
            span, inner, inner_len = "outside", "host", float("inf")
            for n, s, e in self.host:
                if s <= gs <= e:
                    if n.startswith(SPAN_PREFIX):
                        if span == "outside" or e - s < span_len:
                            span, span_len = n[len(SPAN_PREFIX):], e - s
                    elif e - s < inner_len:
                        inner, inner_len = n, e - s
            out.append([f"{span}/{inner}", (ge - gs) * 1e-6])
        return out
