"""The port's spans (`utils/trace.py`) on the CPU: nothing is recorded
without a profiler; under `torch.profiler` a small RGB-D system in the
pipelined loop records its stages nested as documented, on the profiler's
clock, and computes what it computes without one; the spans inside
`track_frame_fused` also record under `torch.vmap` (`BatchedTracker`)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_port  # noqa: F401  (thread settings)
from orb_slam2_e_tpu_torch.models.map_state import MapState
from orb_slam2_e_tpu_torch.models.system import (Sensor, SlamSystem,
                                                 SystemConfig)
from orb_slam2_e_tpu_torch.ops.camera import Camera
from orb_slam2_e_tpu_torch.parallel.batched import BatchedTracker
from orb_slam2_e_tpu_torch.utils import trace
from orb_slam2_e_tpu_torch.utils.synthetic import (SyntheticScene,
                                                   orbit_trajectory)

W, H, N_FEATURES, N_LEVELS = 240, 180, 300, 3
FX = 195.0
FRAMES = 6        # init, then frames that insert; one drain in frame 3 and 5
TIMED = 2         # the frame held against a profiler range around its call
# every name PERF.md section 3 documents
DOCUMENTED = {
    "frame", "drain", "bookkeeping", "extract", "extract.orb",
    "extract.stereo", "rectify", "track", "track.motion", "track.refkf",
    "track.local_map", "track.pose_lm", "map", "map.insert",
    "map.cull_points", "map.triangulate", "map.fuse", "map.refresh",
    "map.local_ba", "map.cull_kf", "loop.dispatch", "loop.harvest",
    "loop.close", "gba", "init", "reloc", "wait.predicate", "wait.flags",
    "wait.pending_flags", "wait.mono_init", "wait.insert", "wait.loop_query",
    "wait.sim3_verify", "wait.loop_fuse", "wait.cull_kf", "wait.vocab"}
# what this run exercises
EXPECTED = {"frame", "drain", "bookkeeping", "extract", "extract.orb",
            "track", "track.motion", "track.refkf", "track.local_map",
            "track.pose_lm", "map", "map.insert", "map.cull_points",
            "map.triangulate", "map.fuse", "map.refresh", "map.local_ba",
            "map.cull_kf", "init", "wait.predicate", "wait.pending_flags",
            "wait.cull_kf"}


def _frames():
    scene = SyntheticScene(n_points=400, seed=1, width=W, height=H, fx=FX,
                           fy=FX, cx=W / 2, cy=H / 2)
    poses, _ = orbit_trajectory(n_frames=20, radius=1.2, forward=0.05)
    return [(scene.render(R, t).astype(np.uint8), scene.depth_map(R, t))
            for R, t in poses[:FRAMES + 1]]


def _system(pipeline=True):
    cam = Camera.create(fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=30.0, width=W,
                        height=H)
    return SlamSystem(cam, SystemConfig(
        max_keyframes=16, max_points=2048, n_features=N_FEATURES,
        n_levels=N_LEVELS, max_frames_between_kf=2, loop_closing=False,
        pipeline=pipeline), Sensor.RGBD, device="cpu")


@pytest.fixture(scope="module")
def runs():
    """The same frames through two systems: without a profiler (and what
    it recorded), then under a CPU profiler with a range around frame
    TIMED's call (the records and that range's kineto interval)."""
    frames = _frames()
    trace.clear()
    off = _system()
    for k in range(FRAMES):
        off.track_rgbd(*frames[k], k / 30.0)
    off.get_trajectory()
    off_spans = trace.spans()
    on = _system()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(FRAMES):
            if k == TIMED:
                # the images already tensors, so that the call opens its
                # span at once; a first range pays the profiler's warm-up
                img, depth = (torch.as_tensor(a) for a in frames[k])
                with torch.profiler.record_function("test.warm"):
                    pass
                with torch.profiler.record_function("test.frame"):
                    on.track_rgbd(img, depth, k / 30.0)
            else:
                on.track_rgbd(*frames[k], k / 30.0)
        on.get_trajectory()
    recs, table = trace.spans(), trace.summary()
    rng = [(ev.start_ns(), ev.end_ns())
           for ev in prof.profiler.kineto_results.events()
           if ev.name() == "test.frame"]
    return {"off": off, "off_spans": off_spans, "on": on, "spans": recs,
            "summary": table, "range": rng, "frames": frames}


def _root(recs, i):
    while recs[i].parent >= 0:
        i = recs[i].parent
    return recs[i]


def test_nothing_recorded_without_a_profiler(runs):
    assert runs["off_spans"] == []


def test_names_are_documented_and_nested(runs):
    recs = runs["spans"]
    names = {s.name for s in recs}
    assert EXPECTED <= names <= DOCUMENTED, names
    for s in recs:
        assert s.t1_ns is not None and s.t0_ns <= s.t1_ns
        if s.parent >= 0:
            p = recs[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns, (s, p)
    roots = [s for s in recs if s.parent < 0]
    assert [s.frame for s in roots if s.name == "frame"] == list(
        range(FRAMES))
    assert {s.name for s in roots} == {"frame", "drain"}


def test_three_pose_solves_per_tracked_frame(runs):
    recs = runs["spans"]
    tracks = [i for i, s in enumerate(recs) if s.name == "track"]
    assert len(tracks) == FRAMES - 1          # every frame after the first
    for i in tracks:
        solves = [s for s in recs if s.name == "track.pose_lm"
                  and recs[s.parent].parent == i]
        assert sorted(recs[s.parent].name for s in solves) == [
            "track.local_map", "track.motion", "track.refkf"]
        assert recs[i].frame == _root(recs, i).frame


def test_bookkeeping_is_for_an_earlier_frame(runs):
    recs = runs["spans"]
    books = [i for i, s in enumerate(recs) if s.name == "bookkeeping"]
    # frames 1-5 are read back: two drains inside frames 3 and 5, one in
    # get_trajectory (a root drain, frame -1)
    assert sorted(recs[i].frame for i in books) == list(range(1, FRAMES))
    for i in books:
        root = _root(recs, i)
        if root.name == "frame":
            assert recs[i].frame < root.frame
        for s in recs:                     # the work under it
            if s.parent == i:
                assert s.frame == recs[i].frame


def test_self_time_sums_to_the_roots(runs):
    recs = runs["spans"]
    table = runs["summary"]
    roots_ms = sum((s.t1_ns - s.t0_ns) / 1e6 for s in recs if s.parent < 0)
    assert sum(own for _, _, own in table.values()) == pytest.approx(
        roots_ms, rel=1e-9)
    assert table["track.pose_lm"][0] == 3 * (FRAMES - 1)
    n, tot, own = table["map"]
    assert own < tot and n == sum(1 for s in recs if s.name == "map")


def test_spans_on_the_profilers_clock(runs):
    (t0, t1), = runs["range"]
    frame, = [s for s in runs["spans"]
              if s.name == "frame" and s.frame == TIMED]
    assert t0 <= frame.t0_ns < t0 + 1e6
    assert t1 - 1e6 < frame.t1_ns <= t1


def test_results_equal_with_and_without_the_profiler(runs):
    off, on = runs["off"], runs["on"]
    for a, b in zip(off.get_trajectory(), on.get_trajectory()):
        assert np.array_equal(a, b)
    for f in MapState._fields:
        assert torch.equal(getattr(off.map, f), getattr(on.map, f)), f
    assert off.stats == on.stats


def test_sync_loop_spans(runs):
    """The synchronous loop reads each frame's flags at once (`wait.flags`)
    and an insertion's counts in its `map` span (`wait.insert`)."""
    slam = _system(pipeline=False)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(3):
            slam.track_rgbd(*runs["frames"][k], k / 30.0)
    recs = trace.spans()
    names = [s.name for s in recs]
    assert names.count("wait.flags") == 2 and "drain" not in names
    inserts = [i for i, s in enumerate(recs) if s.name == "wait.insert"]
    assert inserts and all(recs[recs[i].parent].name == "map"
                           for i in inserts)
    assert [s.frame for s in recs if s.name == "frame"] == [0, 1, 2]


def test_batched_step_records_under_vmap(runs):
    slam = runs["off"]
    bt = BatchedTracker(slam.cam, slam.track_cfg, [slam.map] * 2,
                        n_features=N_FEATURES, n_levels=N_LEVELS,
                        device="cpu")
    bt.bootstrap([slam.last_frame] * 2)
    img = runs["frames"][FRAMES][0]
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        ok, _ = bt.step(np.stack([img, img]), [slam.last_kf_slot] * 2)
    assert bool(ok.all())
    recs = trace.spans()
    assert [s.name for s in recs if s.parent < 0] == ["track"]
    assert sum(s.name == "track.pose_lm" for s in recs) == 3
    assert all(s.frame == -1 for s in recs)


def test_bounded_buffer_and_clear(monkeypatch):
    """When full, the oldest half goes and a span whose parent went reads
    as a root; a span open across `clear()` is not recorded."""
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    monkeypatch.setattr(trace, "CAPACITY", 4)
    trace.clear()
    with trace.span("a", 7):
        for _ in range(5):
            with trace.span("b"):
                pass
    recs = trace.spans()
    assert [(s.name, s.parent, s.frame) for s in recs] == [("b", -1, 7)] * 4
    assert all(s.t1_ns is not None for s in recs)
    with trace.span("c"):
        trace.clear()
        with trace.span("d"):
            with trace.span("e"):
                pass
    assert [(s.name, s.parent) for s in trace.spans()] == [("d", -1),
                                                           ("e", 0)]
    trace.clear()
