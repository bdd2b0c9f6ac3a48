"""`segment_sum_roofline` reads the window's first three mapping passes,
each profiled in a session of its own: the reader on made-up profiler
events at a hand-worked value; a traced tiny run profiles three passes,
records their segment sums and keeps them out of the `map` span's samples
and out of the stretch; an untraced tiny run starts no profiler session and
records no call."""

import os

import pytest
import torch

from slambench import harness, run
from slambench.reference.trace import Events
from slambench.tests.tiny import tiny_cell
from slambench.traffic import stream

from orb_slam2_e_tpu_torch.utils import trace as program

SEED = 2 ** 31 + 17
US = 1000       # ns per microsecond
read = harness.metric_reader("segment_sum_roofline")


def kernels(name, *durations_us):
    """Device events (name, start us, end us), one launch per duration."""
    out, t = [], 0.0
    for d in durations_us:
        out.append((name, t, t + d))
        t += d + 10.0
    return out


def traced(stretch_device, captures):
    tr = harness.Trace()
    tr.events = Events(device=stretch_device, host=[])
    tr.stretch = {"frames": 3, "wall_s": 1.0, "t0_us": 0.0, "t1_us": 1e6}
    tr.captures = [(Events(device=dev, host=[]), bounds)
                   for dev, bounds in captures]
    return tr


def test_reads_the_captures_not_the_stretch():
    # the stretch's launches (no mapping pass there, or one) are not read
    stretch = kernels("fast_nms_blur_kernel", 20.0)
    caps = [(kernels("void segment_sum_kernel<4>", 10.0, 30.0),
             [2e-6, 6e-6]),
            (kernels("void segment_sum_kernel<4>", 20.0), [2e-6])]
    # bounds 10 us over 60 us of device time
    assert read(traced(stretch, caps)) == pytest.approx(100.0 / 6)
    stretch += kernels("void segment_sum_kernel<4>", 1.0)
    assert read(traced(stretch, caps)) == pytest.approx(100.0 / 6)


def test_a_count_mismatch_or_no_launch_reads_nothing():
    one = (kernels("segment_sum_kernel", 10.0), [1e-6])
    assert read(traced([], [one, (kernels("segment_sum_kernel", 10.0),
                                  [1e-6, 1e-6])])) is None
    assert read(traced(kernels("segment_sum_kernel", 10.0), [])) is None
    assert read(traced([], [([], [])])) is None


def tiny_run(seconds, trace):
    cell = tiny_cell("tum1_rgbd.desk_xyz")
    cell.mix = dict(cell.mix, profile_frames=[1, 1])
    return run.run_cell(cell, SEED, seconds, trace, "cpu", 0.0)


def test_traced_run_profiles_the_first_three_mapping_passes():
    # the tiny cell inserts a keyframe on every frame; 12 s holds more than
    # three of them
    out, line = tiny_run(12.0, True)
    assert line["correct"] is True, line["checks"]
    tr = out["trace"]
    assert len(tr.captures) == stream.CAPTURES == 3
    for events, bounds in tr.captures:
        assert bounds and all(b > 0 for b in bounds)
        assert isinstance(events, Events)
    assert len(out["info"]["capture_s"]) == stream.CAPTURES
    # each session tears the device tracer down as it ends
    assert os.environ["TEARDOWN_CUPTI"] == "1"
    # the window runs its seconds outside the sessions
    window_s = out["attempted"] / out["end_to_end"]["frames_per_s"]
    assert window_s >= 12.0 + sum(out["info"]["capture_s"])
    window_maps = round(out["info"]["keyframes_per_100"]
                        * out["attempted"] / 100)
    assert window_maps > stream.CAPTURES
    # a captured pass is no sample of the `map` span
    assert len(tr.spans["map"]) == window_maps - stream.CAPTURES
    # each session lies inside one `map` span of the program's, recorded
    # because the session ran, and that span ends before the stretch
    maps = [s for s in program.spans() if s.name == "map"
            and s.t1_ns is not None]
    for events, _ in tr.captures:
        a = min(s for _, s, _ in events.host) * 1e3
        b = max(e for _, _, e in events.host) * 1e3
        around = [s for s in maps if s.t0_ns <= a + US and b - US <= s.t1_ns]
        assert len(around) == 1
        assert around[0].t1_ns < tr.stretch["t0_us"] * 1e3


def test_untraced_run_starts_no_profiler_and_records_no_call(monkeypatch):
    started, installed = [], []
    real = torch.profiler.profile

    class Counted(real):
        def __init__(self, *a, **k):
            started.append(1)
            super().__init__(*a, **k)

    for owner, attr in ((harness.Hooks, "record"),
                        (harness.Hooks, "profile_first"),
                        (harness, "warm_profiler")):
        fn = getattr(owner, attr)

        def counted(*a, _fn=fn, _attr=attr, **k):
            installed.append(_attr)
            return _fn(*a, **k)
        monkeypatch.setattr(owner, attr, counted)
    monkeypatch.setattr(torch.profiler, "profile", Counted)
    out, line = tiny_run(1.0, False)
    assert line["correct"] is True, line["checks"]
    assert out["trace"] is None and "capture_s" not in out["info"]
    assert started == [] and installed == []
    # the same counters see a traced run's sessions and recorders: the
    # warm-up, at least one capture and the stretch
    tiny_run(1.0, True)
    assert len(started) >= 3
    assert {"record", "profile_first", "warm_profiler"} <= set(installed)
