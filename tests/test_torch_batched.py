"""The port's batched lock-step tracker (`parallel/batched.py`) and batched
extraction (`OrbExtractor.extract_batch`) on the CPU: every lane against
the single-lane functions of the port, and the tracker against the
reference's `BatchedTracker` on the same maps and frames.

The map is built once by the port's RGB-D system on the orbit scene at
320x240 (400 features, 4 levels); the lanes start at staggered frames of
the orbit, as bench.py's lanes do, bootstrapped from the tracked poses."""

import time

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from _torch_port import as_jax, jnp_dict, tnp
from orb_slam2_e_tpu.models.frame import Frame as JFrame
from orb_slam2_e_tpu.models.map_state import MapState as JMapState
from orb_slam2_e_tpu.models.tracking import TrackConfig as JTrackConfig
from orb_slam2_e_tpu.ops import camera as jcam
from orb_slam2_e_tpu.parallel.batched import BatchedTracker as JBatched
from orb_slam2_e_tpu_torch.models import tracking as T
from orb_slam2_e_tpu_torch.models.frame import frame_from_features
from orb_slam2_e_tpu_torch.models.map_state import MapState
from orb_slam2_e_tpu_torch.models.system import (SlamSystem, SystemConfig,
                                                 Sensor)
from orb_slam2_e_tpu_torch.ops import kernels, lie, scatter
from orb_slam2_e_tpu_torch.ops.camera import Camera
from orb_slam2_e_tpu_torch.ops.orb import OrbExtractor
from orb_slam2_e_tpu_torch.parallel.batched import BatchedTracker
from orb_slam2_e_tpu_torch.utils import convert
from orb_slam2_e_tpu_torch.utils.synthetic import (SyntheticScene,
                                                   orbit_trajectory)

W, H, N_FEATURES, N_LEVELS = 320, 240, 400, 4
CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, bf=40.0, width=W,
           height=H)
MAP_FRAMES = 10
B, STEPS = 3, 3
JAX_B, JAX_STEPS = 2, 2
POSE_ATOL = 1e-4      # tests/test_torch_matching_pose.py:20


@pytest.fixture(scope="module")
def built():
    """The port's RGB-D map of the first MAP_FRAMES frames, and the
    orbit's grey images."""
    scene = SyntheticScene(n_points=400, seed=1, width=W, height=H,
                           fx=CAM["fx"], fy=CAM["fy"], cx=CAM["cx"],
                           cy=CAM["cy"])
    poses, _ = orbit_trajectory(n_frames=20, radius=1.2, forward=0.03)
    images = [scene.render(R, t).astype(np.uint8) for R, t in poses]
    cam = Camera.create(**CAM)
    slam = SlamSystem(cam, SystemConfig(
        max_keyframes=16, max_points=4096, n_features=N_FEATURES,
        n_levels=N_LEVELS, pipeline=False, loop_closing=False), Sensor.RGBD,
        device="cpu")
    for k in range(MAP_FRAMES):
        slam.track_rgbd(images[k], scene.depth_map(*poses[k]), k / 30.0)
    assert len(slam.trajectory) == MAP_FRAMES
    assert all(p7 is not None for _, p7 in slam.trajectory)
    return slam, images


def _lanes(slam, n_lanes, steps):
    """bench.py's protocol: lane b starts at frame MAP_FRAMES - 1 - steps
    - b, from its tracked pose."""
    starts = [MAP_FRAMES - 1 - steps - b for b in range(n_lanes)]
    ref = max(slam.last_kf_slot, 0)
    return starts, torch.full((n_lanes,), ref, dtype=torch.int32)


def _boot_frames(slam, extractor, images, starts):
    return [frame_from_features(slam.cam, extractor(torch.from_numpy(
        images[s])))._replace(pose7=slam.trajectory[s][1]) for s in starts]


def test_extract_batch_lanes_equal_single(built):
    _, images = built
    ex = OrbExtractor(N_FEATURES, 1.2, N_LEVELS)
    batch = torch.from_numpy(np.stack(images[:B]))
    got = ex.extract_batch(batch)
    for b in range(B):
        want = ex._extract(batch[b])
        for k in want._fields:
            assert getattr(got, k).shape[0] == B
            assert torch.equal(getattr(got, k)[b], getattr(want, k)), (b, k)


@pytest.fixture(scope="module")
def lock_step(built, monkeypatch_module):
    """The batched tracker's B lanes over STEPS steps, and each lane's
    yardstick: the single-lane extraction, frame and `track_frame_fused`
    in a Python loop, with `have_velocity` a Python bool as the system
    passes it. Also counts the kernel-wrapper calls of each step."""
    slam, images = built
    starts, ref = _lanes(slam, B, STEPS)
    bt = BatchedTracker(slam.cam, slam.track_cfg, [slam.map] * B,
                        n_features=N_FEATURES, n_levels=N_LEVELS,
                        device="cpu")
    boot = _boot_frames(slam, bt.extractor, images, starts)
    bt.bootstrap(boot)
    calls = {"batch": 0, "pyramid": 0}
    for name, key in (("fast_nms_blur_batch", "batch"),
                      ("fast_nms_blur_pyramid", "pyramid")):
        fn = getattr(kernels, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch_module.setattr(kernels, name, counted)
    batched = []
    for k in range(STEPS):
        imgs = torch.from_numpy(np.stack([images[s + 1 + k] for s in starts]))
        ok, n_in = bt.step(imgs, ref)
        batched.append((ok.clone(), n_in.clone(),
                        convert.unstack_lanes(bt.last_frames),
                        convert.unstack_lanes(bt.state), bt.vels.clone(),
                        bt.have_vel.clone()))
    step_calls = dict(calls)
    monkeypatch_module.undo()

    single = []
    for b in range(B):
        state, last = slam.map, boot[b]
        vel, have_vel = lie.pose7_identity(device="cpu"), False
        lane = []
        for k in range(STEPS):
            frame = frame_from_features(slam.cam, bt.extractor._extract(
                torch.from_numpy(images[starts[b] + 1 + k])))
            state, last, vel, flags = T.track_frame_fused(
                slam.cam, slam.track_cfg, state, frame, last, vel, have_vel,
                int(ref[b]))
            have_vel = bool(flags[0])
            lane.append((flags, last, state, vel))
        single.append(lane)
    return batched, single, step_calls


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("lane", range(B))
def test_batched_lanes_equal_single_lane(lock_step, lane):
    """Flags and the map's integer-valued counters exactly, poses and
    velocities within POSE_ATOL, on every step; every lane tracks."""
    batched, single, _ = lock_step
    for k in range(STEPS):
        ok, n_in, frames, states, vels, have_vel = batched[k]
        flags, last, state, vel = single[lane][k]
        assert bool(ok[lane]) == bool(flags[0]) and bool(ok[lane]), k
        assert int(n_in[lane]) == int(flags[1]), k
        assert bool(have_vel[lane]) == bool(flags[0])
        np.testing.assert_array_equal(tnp(frames[lane].point_ids),
                                      tnp(last.point_ids), err_msg=str(k))
        for f in ("lm_visible", "lm_found"):
            np.testing.assert_array_equal(tnp(getattr(states[lane], f)),
                                          tnp(getattr(state, f)),
                                          err_msg=f"{f} step {k}")
        np.testing.assert_allclose(tnp(frames[lane].pose7), tnp(last.pose7),
                                   atol=POSE_ATOL, err_msg=str(k))
        np.testing.assert_allclose(tnp(vels[lane]), tnp(vel),
                                   atol=POSE_ATOL, err_msg=str(k))


def test_batched_step_extracts_with_one_kernel_call(lock_step):
    """Each step takes the batch wrapper once (one launch of the kernel
    over the B pyramids on the card) and never the one-pyramid wrapper."""
    _, _, calls = lock_step
    assert calls == {"batch": STEPS, "pyramid": 0}


def test_maps_other_than_counters_unchanged(lock_step, built):
    """Localization mode: a step changes only the visibility counters."""
    slam, _ = built
    batched, _, _ = lock_step
    for state in batched[-1][3]:
        for f in MapState._fields:
            if f not in ("lm_visible", "lm_found"):
                assert torch.equal(getattr(state, f), getattr(slam.map, f)), f


def test_stack_lanes_round_trip_and_numpy(built):
    """stack_lanes / unstack_lanes are inverse, and stacked numpy arrays
    (a reference BatchedTracker's state) cross as a stacked MapState."""
    slam, _ = built
    maps = [slam.map, slam.map._replace(lm_visible=slam.map.lm_visible + 1)]
    stacked = convert.stack_lanes(maps)
    assert stacked.kf_pose7.shape == (2,) + tuple(slam.map.kf_pose7.shape)
    for got, want in zip(convert.unstack_lanes(stacked), maps):
        for f in MapState._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    arrays = {k: np.stack([tnp(getattr(m, k)) for m in maps])
              for k in MapState._fields}
    back = convert.map_state_from_numpy(arrays, "cpu")
    for f in MapState._fields:
        assert torch.equal(getattr(back, f), getattr(stacked, f)), f


def test_predict_pose7_tensor_form(built):
    """The bool-tensor form of the prediction selects what the Python-bool
    form computes."""
    slam, _ = built
    last = frame_from_features(slam.cam, OrbExtractor(50, 1.2, 1)._extract(
        torch.zeros((64, 64))))._replace(pose7=slam.trajectory[3][1])
    vel = slam.trajectory[4][1]
    for hv in (False, True):
        want = T._predict_pose7(last, vel, hv)
        got = T._predict_pose7(last, vel, torch.tensor(hv))
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_lane"])
def test_masked_set_under_vmap(shared):
    """`scatter.masked_set` under torch.vmap, with the array shared by the
    lanes or one per lane, equals the call lane by lane."""
    rng = np.random.RandomState(0)
    arr = torch.from_numpy(rng.rand(3, 9, 2).astype(np.float32))
    idx = torch.from_numpy(np.stack([rng.permutation(9)[:5]
                                     for _ in range(3)]))
    ok = torch.from_numpy(rng.rand(3, 5) < 0.6)
    val = torch.from_numpy(rng.rand(3, 5, 2).astype(np.float32))
    if shared:
        got = torch.vmap(lambda i, o, v: scatter.masked_set(arr[0], i, o, v))(
            idx, ok, val)
    else:
        got = torch.vmap(scatter.masked_set)(arr, idx, ok, val)
    for b in range(3):
        want = scatter.masked_set(arr[0] if shared else arr[b], idx[b], ok[b],
                                  val[b])
        assert torch.equal(got[b], want)


@pytest.fixture(scope="module")
def against_reference(built):
    """Both packages' BatchedTracker at n_levels=1 (level 0 is exact
    between the packages) on the same stacked maps and bootstrap frames."""
    slam, images = built
    starts, ref = _lanes(slam, JAX_B, JAX_STEPS)
    cfg = slam.track_cfg._replace(n_levels=1)
    bt = BatchedTracker(slam.cam, cfg, [slam.map] * JAX_B,
                        n_features=N_FEATURES, n_levels=1, device="cpu")
    boot = _boot_frames(slam, bt.extractor, images, starts)
    bt.bootstrap(boot)
    jmap = as_jax(JMapState, convert.to_numpy(slam.map))
    jbt = JBatched(jcam.Camera(**{k: jnp.asarray(v) for k, v in
                                  convert.to_numpy(slam.cam).items()}),
                   JTrackConfig(**cfg._asdict()), [jmap] * JAX_B,
                   n_features=N_FEATURES, n_levels=1)
    jbt.bootstrap([as_jax(JFrame, convert.to_numpy(f)) for f in boot])
    out, t_jax = [], 0.0
    for k in range(JAX_STEPS):
        imgs = np.stack([images[s + 1 + k] for s in starts])
        ok, n_in = bt.step(torch.from_numpy(imgs), ref)
        t0 = time.perf_counter()
        jok, jn_in = jbt.step(jnp.asarray(imgs), jnp.asarray(tnp(ref)))
        jok = np.asarray(jok)
        t_jax += time.perf_counter() - t0
        out.append(((tnp(ok), tnp(n_in), convert.to_numpy(bt.last_frames),
                     tnp(bt.vels), tnp(bt.state.lm_visible),
                     tnp(bt.state.lm_found)),
                    (jok, np.asarray(jn_in), jnp_dict(jbt.last_frames),
                     np.asarray(jbt.vels), np.asarray(jbt.state.lm_visible),
                     np.asarray(jbt.state.lm_found))))
    print(f"reference BatchedTracker, B={JAX_B}, n_levels=1: {t_jax:.1f} s "
          f"for {JAX_STEPS} steps, the first step's compile included")
    return out


@pytest.mark.parametrize("lane", range(JAX_B))
def test_batched_tracker_matches_reference(against_reference, lane):
    for k, (mine, ref) in enumerate(against_reference):
        ok, n_in, frames, vels, vis, found = mine
        jok, jn_in, jframes, jvels, jvis, jfound = ref
        assert bool(ok[lane]) == bool(jok[lane]) and bool(ok[lane]), k
        assert int(n_in[lane]) == int(jn_in[lane]), k
        np.testing.assert_array_equal(frames["point_ids"][lane],
                                      jframes["point_ids"][lane])
        np.testing.assert_array_equal(vis[lane], jvis[lane])
        np.testing.assert_array_equal(found[lane], jfound[lane])
        np.testing.assert_allclose(frames["pose7"][lane],
                                   jframes["pose7"][lane], atol=POSE_ATOL)
        np.testing.assert_allclose(vels[lane], jvels[lane], atol=POSE_ATOL)
