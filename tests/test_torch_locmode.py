"""The port's localization-only step against the reference (CPU):
`track_frame_loc` and `track_motion_model_vo` on the constructed frames of
tests/test_vo_mode.py (an empty map rescued by temporary VO points, a map in
view with the VO flag down, monocular frames without depth), from equal
numpy inputs; then the mode through `SlamSystem`, where the map must come
out as it went in."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from _torch_port import jnp_dict, tnp
import test_vo_mode as vo
from orb_slam2_e_tpu.models import tracking as JT
from orb_slam2_e_tpu.models.map_state import MapState as JMap
from orb_slam2_e_tpu.ops import lie as jlie
from orb_slam2_e_tpu_torch.models import tracking as TT
from orb_slam2_e_tpu_torch.models.system import (SlamSystem, SystemConfig,
                                                 Sensor, TrackState)
from orb_slam2_e_tpu_torch.ops.camera import Camera
from orb_slam2_e_tpu_torch.utils import convert
from orb_slam2_e_tpu_torch.utils.synthetic import (SyntheticScene,
                                                   orbit_trajectory)

# the pose comes out of 10+ Gauss-Newton iterations of the f32 pose
# optimizer on ~200 observations summed in another order
POSE_ATOL = 1e-4


def _case(kind):
    """(state, cur, last, velocity7, have_velocity) as the reference's
    types, for one case of tests/test_vo_mode.py."""
    xyz, desc = vo._scene()
    state = JMap.create(8, vo.N, 1024)
    R0, t0, R1, t1 = vo._poses()
    depth = kind != "mono_no_depth"
    last = vo._frame(xyz, desc, R0, t0, with_depth=depth)
    cur = vo._frame(xyz, desc, R1, t1, with_depth=depth)
    if kind in ("map_points", "no_velocity"):
        n_lm = 60
        state = state._replace(
            lm_xyz=state.lm_xyz.at[:n_lm].set(jnp.asarray(xyz[:n_lm])),
            lm_valid=state.lm_valid.at[:n_lm].set(True),
            lm_desc=state.lm_desc.at[:n_lm].set(jnp.asarray(desc[:n_lm])),
            lm_max_dist=state.lm_max_dist.at[:n_lm].set(100.0))
        last = last._replace(point_ids=last.point_ids.at[:n_lm].set(
            jnp.arange(n_lm, dtype=jnp.int32)))
    vel = jlie.pose7_pack(jnp.asarray(R1), jnp.asarray(t1))
    return state, cur, last, vel, kind != "no_velocity", (R1, t1)


def _port(state, cur, last, vel):
    return (convert.camera_from_numpy(jnp_dict(vo._cam()), "cpu"),
            TT.TrackConfig(*vo._cfg()),
            convert.map_state_from_numpy(jnp_dict(state), "cpu"),
            convert.frame_from_numpy(jnp_dict(cur), "cpu"),
            convert.frame_from_numpy(jnp_dict(last), "cpu"),
            torch.from_numpy(np.array(vel)))


def _assert_frames_agree(ft, fj):
    j, t = jnp_dict(fj), convert.to_numpy(ft)
    for k in j:
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
        if k == "pose7":
            np.testing.assert_allclose(t[k], j[k], atol=POSE_ATOL)
        else:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


# kind -> the flags [ok, vo] the reference's own tests assert
_EXPECT = {"empty_map": (1, 1), "map_points": (1, 0),
           "mono_no_depth": (0, None), "no_velocity": (None, None)}


@pytest.mark.parametrize("kind", list(_EXPECT))
def test_track_frame_loc_matches(kind):
    state, cur, last, vel, have_vel, (R1, t1) = _case(kind)
    fj, vj, flags_j = JT.track_frame_loc(
        vo._cam(), vo._cfg(), state, cur, last, vel, jnp.bool_(have_vel),
        jnp.int32(0))
    cam_t, cfg_t, st, cur_t, last_t, vel_t = _port(state, cur, last, vel)
    before = {k: v.clone() for k, v in st._asdict().items()}
    ft, vt, flags_t = TT.track_frame_loc(cam_t, cfg_t, st, cur_t, last_t,
                                         vel_t, have_vel, 0)
    assert flags_t.dtype == torch.int32 and flags_t.shape == (6,)
    np.testing.assert_array_equal(tnp(flags_t), np.asarray(flags_j))
    ok, vo_flag = _EXPECT[kind]
    if ok is not None:
        assert int(flags_t[0]) == ok
    if vo_flag is not None:
        assert int(flags_t[4]) == vo_flag
    _assert_frames_agree(ft, fj)
    np.testing.assert_allclose(tnp(vt), np.asarray(vj), atol=POSE_ATOL)
    if kind == "empty_map":
        assert int(flags_t[5]) > 20             # plenty of VO inliers
        _, t_est = (tnp(x) for x in TT.lie.pose7_unpack(ft.pose7))
        assert np.linalg.norm(t_est - t1) < 0.02
    # the step left the map as it was
    for k, v in st._asdict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("kind", ["empty_map", "map_points"])
def test_track_motion_model_vo_matches(kind):
    state, cur, last, vel, _, _ = _case(kind)
    fj, nmap_j, ntot_j = JT.track_motion_model_vo(
        vo._cam(), vo._cfg(), state, cur, last, vel)
    cam_t, cfg_t, st, cur_t, last_t, vel_t = _port(state, cur, last, vel)
    ft, nmap_t, ntot_t = TT.track_motion_model_vo(cam_t, cfg_t, st, cur_t,
                                                  last_t, vel_t)
    assert int(nmap_t) == int(nmap_j) and int(ntot_t) == int(ntot_j)
    assert (int(nmap_t) == 0) == (kind == "empty_map")
    assert int(ntot_t) > 100
    _assert_frames_agree(ft, fj)


# ---------------------------------------------------------------------------
# Through SlamSystem
# ---------------------------------------------------------------------------

SCENE = dict(n_points=400, seed=3, width=320, height=240, fx=260, fy=260,
             cx=160, cy=120)
CAM = dict(fx=260, fy=260, cx=160, cy=120, bf=40.0, width=320, height=240)
CFG = dict(max_keyframes=12, max_points=2048, n_features=300, n_levels=4,
           max_frames_between_kf=2, pipeline=False)


def _map_snapshot(s):
    return {k: v.clone() for k, v in s.map._asdict().items()}


def _assert_map_unchanged(s, snap):
    for k, v in s.map._asdict().items():
        assert torch.equal(v, snap[k]), k


@pytest.fixture(scope="module")
def mapped():
    """6 RGB-D frames mapped with the default loop closing on, then the
    frames that follow: (system, scene, poses)."""
    scene = SyntheticScene(**SCENE)
    poses, _ = orbit_trajectory(n_frames=14, radius=0.6, forward=0.05)
    s = SlamSystem(Camera.create(**CAM), SystemConfig(**CFG), Sensor.RGBD,
                   device="cpu")
    for k, (R, t) in enumerate(poses[:6]):
        assert s.track_rgbd(scene.render(R, t), scene.depth_map(R, t),
                            k / 30.0) is not None
    assert s.n_keyframes >= 3 and not s.localization_only
    return s, scene, poses


def test_localization_mode_leaves_the_map_unchanged(mapped):
    s, scene, poses = mapped
    snap = _map_snapshot(s)
    n_kf, inserted = s.n_keyframes, s.stats["kf_inserted"]
    s.activate_localization_mode()
    assert s.localization_only
    for k in range(6, 11):
        R, t = poses[k]
        pose = s.track_rgbd(scene.render(R, t), scene.depth_map(R, t),
                            k / 30.0)
        assert pose is not None and s.get_tracking_state() == TrackState.OK
        assert not s.vo_mode            # the map stays in view on this orbit
        c = -np.asarray(pose[0]).T @ np.asarray(pose[1])
        c_gt = -poses[k][0].T @ poses[k][1]
        assert np.linalg.norm(c - c_gt) < 0.05
    _assert_map_unchanged(s, snap)
    assert (s.n_keyframes, s.stats["kf_inserted"]) == (n_kf, inserted)
    # and mapping resumes afterwards
    s.deactivate_localization_mode()
    assert not s.localization_only
    for k in range(11, 14):
        R, t = poses[k]
        assert s.track_rgbd(scene.render(R, t), scene.depth_map(R, t),
                            k / 30.0) is not None
    assert s.stats["kf_inserted"] > inserted


def test_vo_points_carry_the_track_off_the_map():
    """`mapping=False` from the start on a map carried in, then the camera
    turns away from everything mapped: VO points keep the track, the VO
    flag rises, and the map still does not change."""
    scene = SyntheticScene(**SCENE)
    poses, _ = orbit_trajectory(n_frames=4, radius=0.6, forward=0.05)
    s = SlamSystem(Camera.create(**CAM), SystemConfig(**CFG), Sensor.RGBD,
                   device="cpu")
    for k, (R, t) in enumerate(poses):
        s.track_rgbd(scene.render(R, t), scene.depth_map(R, t), k / 30.0)
    loc = SlamSystem(Camera.create(**CAM),
                     SystemConfig(mapping=False, **CFG), Sensor.RGBD,
                     device="cpu")
    assert loc.localization_only
    # carry the mapped state in: the map, its database and the last frame
    loc.map, loc.bow_db, loc.vocab = s.map, s.bow_db, s.vocab
    loc.last_frame, loc.velocity7 = s.last_frame, s.velocity7
    loc.state, loc.frame_id = s.state, s.frame_id
    loc.last_kf_slot, loc.n_keyframes = s.last_kf_slot, s.n_keyframes
    # strip the map down to a handful of landmarks: fewer than 10 real
    # matches per frame, as at the edge of a mapped region
    keep = torch.zeros_like(loc.map.lm_valid)
    keep[torch.nonzero(loc.map.lm_valid)[:6, 0]] = True
    loc.map = loc.map._replace(lm_valid=keep)
    loc.last_frame = loc.last_frame._replace(point_ids=torch.where(
        keep[loc.last_frame.point_ids.clamp(min=0).long()],
        loc.last_frame.point_ids, -1))
    snap = _map_snapshot(loc)
    R, t = poses[-1]
    seen_vo = False
    for k in range(4, 8):
        t = t + np.array([-0.02, 0.0, 0.0], np.float32)
        pose = loc.track_rgbd(scene.render(R, t), scene.depth_map(R, t),
                              k / 30.0)
        assert pose is not None, k
        seen_vo |= loc.vo_mode
        # pure VO on top of a mapped pose that is itself ~0.02 m off
        np.testing.assert_allclose(np.asarray(pose[1]), t, atol=0.05)
    assert seen_vo
    _assert_map_unchanged(loc, snap)
    assert loc.stats["kf_inserted"] == 0
