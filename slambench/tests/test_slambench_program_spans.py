"""The five readers of the program's own spans (`metrics/pose_lm_launches`,
`extract_launches`, `local_ba_ms_per_kf`, `host_wait_ms`,
`implicit_syncs_per_frame`) on made-up profiler events and span records,
at hand-worked values; without the program's span module (a checkout from
before it) each reads nothing; and on a traced tiny stereo run on the CPU
they find the program's spans inside the profiled stretch."""

import sys

import pytest

from slambench import harness, run
from slambench.reference.trace import Events
from slambench.tests.tiny import tiny_cell

from orb_slam2_e_tpu_torch.utils import trace as program

READERS = ["pose_lm_launches", "extract_launches", "local_ba_ms_per_kf",
           "host_wait_ms", "implicit_syncs_per_frame"]
US = 1000       # ns per microsecond


def span(name, t0_us, t1_us, parent=-1, frame=-1):
    return program.Span(name, int(t0_us * US), int(t1_us * US), parent,
                        frame)


def made_up(records, host, frames=2, stretch=(0.0, 10_000.0)):
    """A harness.Trace over `host` events (name, start us, end us) and the
    program records `records`, the stretch from 0 to 10 ms."""
    tr = harness.Trace()
    tr.events = Events(device=[], host=host)
    tr.stretch = {"frames": frames, "wall_s": 0.01, "t0_us": stretch[0],
                  "t1_us": stretch[1]}
    return tr, records


@pytest.fixture
def read(monkeypatch):
    def go(name, made):
        tr, records = made
        monkeypatch.setattr(program, "spans", lambda: list(records))
        return harness.metric_reader(name)(tr)
    return go


# frame 0 from 0 to 4 ms: a solve from 1 to 2 ms inside `track`, an
# `extract` from 0.1 to 0.5 ms; launches on both edges of the solve, one
# just outside each edge and one in the middle
RECS = [span("frame", 0, 4000, frame=0),
        span("extract", 100, 500, 0, 0),
        span("track", 600, 3000, 0, 0),
        span("track.refkf", 900, 2100, 2, 0),
        span("track.pose_lm", 1000, 2000, 3, 0)]
LAUNCHES = [("cudaLaunchKernel", t, t + 1.0)
            for t in (999.5, 1000.0, 1500.0, 2000.0, 2000.5, 300.0)]


def test_launch_on_a_span_edge_counts(read):
    # 1000, 1500 and 2000 lie in the solve: 3 over 2 frames
    made = made_up(RECS, LAUNCHES)
    assert read("pose_lm_launches", made) == 1.5
    assert read("extract_launches", made) == 0.5


def test_nested_wait_counts_once(read):
    recs = RECS + [span("wait.predicate", 3100, 3300, 0, 0),
                   span("wait.cull_kf", 3150, 3200, 5, 0),
                   span("rectify", 5000, 5400)]
    host = [("cudaStreamSynchronize", 3120.0, 3121.0),   # in the waits
            ("cudaStreamSynchronize", 3160.0, 3161.0),
            ("cudaStreamSynchronize", 700.0, 701.0),     # implicit
            ("cudaEventSynchronize", 5200.0, 5201.0),    # in `rectify`
            ("cudaStreamSynchronize", 4500.0, 4501.0),   # in no span
            ("cudaLaunchKernel", 800.0, 801.0)]
    made = made_up(recs, host)
    # the waits cover 3.1-3.3 ms: 0.2 ms over 2 frames
    assert read("host_wait_ms", made) == pytest.approx(0.1)
    assert read("implicit_syncs_per_frame", made) == 1.0


def test_local_ba_per_keyframe(read):
    assert read("local_ba_ms_per_kf", made_up(RECS, [])) is None
    recs = RECS + [span("map", 3000, 3900, 0, 0),
                   span("map.local_ba", 3200, 3700, 5, 0),
                   span("frame", 5000, 8000, frame=1),
                   span("map", 6000, 7000, 7, 1)]
    # 0.5 ms of local BA over two keyframes
    assert read("local_ba_ms_per_kf", made_up(recs, [])) == pytest.approx(
        0.25)


def test_records_outside_the_stretch_are_left_out(read):
    made = made_up(RECS, LAUNCHES, stretch=(0.0, 1800.0))
    assert read("pose_lm_launches", made) is None     # the solve ends later
    assert read("extract_launches", made) == 0.5


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_the_program_spans(name, monkeypatch):
    made = made_up(RECS + [span("map", 3000, 3900, 0, 0)], LAUNCHES)
    monkeypatch.setitem(sys.modules, "orb_slam2_e_tpu_torch.utils.trace",
                        None)
    assert harness.metric_reader(name)(made[0]) is None


def test_traced_tiny_stereo_run_finds_the_program_spans():
    out, _ = run.run_cell(tiny_cell("euroc_stereo.mh_sweep"), 2 ** 31 + 11,
                          1.0, True, "cpu", 0.0)
    tr = out["trace"]
    recs = program.within(tr.stretch["t0_us"] * 1e3,
                          tr.stretch["t1_us"] * 1e3)
    names = {s.name for s in recs}
    assert {"rectify", "frame", "extract", "extract.orb", "extract.stereo",
            "track", "track.pose_lm"} <= names
    assert {s.name for s in recs if s.parent < 0} <= {"rectify", "frame",
                                                       "drain"}
    # the benchmark's own range around each frame holds the program's
    bench = tr.events.spans("frame")
    assert all(any(b0 <= s.t0_ns / 1e3 and s.t1_ns / 1e3 <= b1
                   for b0, b1 in bench)
               for s in recs if s.parent < 0)
    for name in READERS:
        v = harness.metric_reader(name)(tr)
        if name != "local_ba_ms_per_kf" or "map" in names:
            assert v is not None and v >= 0, name
