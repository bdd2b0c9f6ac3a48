"""The port's bundle adjustment, map-state helpers and mapping pass against
the reference, on the same numpy problem and on a JAX map carried across
with utils/convert.py (CPU)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from _torch_port import jnp_dict, tnp
from orb_slam2_e_tpu.models import local_mapping as JLM
from orb_slam2_e_tpu.models import tracking as JT
from orb_slam2_e_tpu.models.system import (SlamSystem as JSys,
                                           SystemConfig as JCfg,
                                           Sensor as JSensor)
from orb_slam2_e_tpu.ops import ba as jba
from orb_slam2_e_tpu.ops import camera as jcam
from orb_slam2_e_tpu.ops import lie as jlie
from orb_slam2_e_tpu_torch.models import local_mapping as TLM
from orb_slam2_e_tpu_torch.models.map_state import MapState
from orb_slam2_e_tpu_torch.ops import ba as tba
from orb_slam2_e_tpu_torch.ops import camera as tcam
from orb_slam2_e_tpu_torch.utils import convert
from orb_slam2_e_tpu_torch.utils.synthetic import (SyntheticScene,
                                                   orbit_trajectory)

# BA: f32 sums in another order, bf16-rounded Schur operands and a 32-step
# CG. The seeds are problems on which the reference itself moves less than
# 1e-4 when its input points change by one ulp. (Seed 0 of `_ba_problem`
# is not one: a 1-ulp change of its points moves the reference's own result
# by 2.2e-3, because the bf16 rounding of the Schur operands is
# discontinuous, so no implementation can hold it to 1e-3.)
BA_SEEDS = [1, 2]
BA_ATOL = 1e-3
BA_COST_RTOL = 0.01
# mapping pass: triangulation solves + 3+4 LM iterations from equal inputs.
# The reference's local BA is chaotic on this window (ROADMAP Q3 #11): a
# 1-ulp change of its input `lm_xyz` moves its own landmarks by 0.0016 /
# 0.018 / 0.0017 m (seeds 0 / 1 / 2; 17 points beyond 1e-3 on seed 1), and
# of `kf_pose7` by 0.0042 / 0.011 / 0.0080 m, while its keyframe poses move
# by at most 7.9e-5. A per-point bound of 1e-3 therefore passes or fails by
# the machine's rounding. Port vs reference here: keyframe poses 4.7e-5,
# landmarks median 2.0e-5, worst 0.011 m (6 of 316 coordinates past 1e-3).
MAP_POSE_ATOL = 1e-3          # valid keyframes, every pose entry
MAP_XYZ_MEDIAN_ATOL = 1e-4    # valid landmarks, median |difference|
MAP_XYZ_MAX_ATOL = 0.05       # valid landmarks, every coordinate (the
                              # e2e bound CENTER_MAX_ATOL)
# pre-BA stages: f32 rounding of equal computations
MAP_XYZ_ATOL = 1e-3
# one triangulation, before BA: both packages solve the 3x3 normal
# equations in f32 (LAPACK in torch, XLA's LU in JAX). Against a float64
# solve both err by up to 1e-3 of the coordinate (median 6e-5) at a
# 0.1 m baseline and 9 m depth, so they may differ by that much.
TRI_RTOL = 1e-3


def _ba_problem(seed, n_cams=6, n_pts=150, o_cap=1024):
    """Cameras on an arc over a point cloud: noisy observations (a third
    with a stereo coordinate, 5% gross outliers), perturbed seeds, the
    first two cameras fixed, padded to a fixed observation capacity."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform([-3, -3, 4], [3, 3, 10], (n_pts, 3)).astype(np.float32)
    poses = []
    for i in range(n_cams):
        R = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.02 * i, 0.0])))
        poses.append((R, -R @ np.array([0.3 * i, 0.0, 0.0], np.float32)))
    oc, op, ouvr = [], [], []
    for c, (R, t) in enumerate(poses):
        xc = pts @ R.T + t
        u = 500 * xc[:, 0] / xc[:, 2] + 320 + rng.randn(n_pts) * 0.5
        v = 500 * xc[:, 1] / xc[:, 2] + 240 + rng.randn(n_pts) * 0.5
        ur = np.where(rng.rand(n_pts) < 0.33, u - 40.0 / xc[:, 2], -1.0)
        bad = rng.rand(n_pts) < 0.05
        u = np.where(bad, u + rng.uniform(-30, 30, n_pts), u)
        vis = (u > 0) & (u < 640) & (v > 0) & (v < 480)
        for p in np.where(vis)[0]:
            oc.append(c)
            op.append(p)
            ouvr.append([u[p], v[p], ur[p]])
    n_obs = len(oc)
    assert n_obs <= o_cap
    pad = o_cap - n_obs
    p7 = []
    for c, (R, t) in enumerate(poses):
        if c >= 2:
            dR, dt = jlie.se3_exp(jnp.asarray(rng.randn(6).astype(np.float32)
                                              * 0.02))
            R, t = (np.asarray(x) for x in jlie.se3_compose(
                dR, dt, jnp.asarray(R), jnp.asarray(t)))
        p7.append(np.asarray(jlie.pose7_pack(jnp.asarray(R),
                                             jnp.asarray(t))))
    octave = rng.randint(0, 4, o_cap)
    valid = np.zeros(o_cap, bool)
    valid[:n_obs] = True
    return dict(
        cam_pose7=np.stack(p7).astype(np.float32),
        cam_free=np.arange(n_cams) >= 2,
        points=(pts + rng.randn(n_pts, 3) * 0.05).astype(np.float32),
        point_valid=rng.rand(n_pts) < 0.97,
        obs_cam=np.array(oc + [0] * pad, np.int32),
        obs_point=np.array(op + [0] * pad, np.int32),
        obs_uvr=np.array(ouvr + [[0.0, 0.0, -1.0]] * pad, np.float32),
        obs_inv_sigma2=(1.0 / 1.2 ** (2 * octave)).astype(np.float32),
        obs_valid=valid)


CAM = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=40.0)


@pytest.mark.parametrize("seed", BA_SEEDS)
def test_ba_solve_matches(seed):
    arrays = _ba_problem(seed)
    rj = jba.ba_solve_jit(jcam.Camera.create(**CAM),
                          jba.BAProblem(**{k: jnp.asarray(v) for k, v in
                                           arrays.items()}),
                          iters_phase1=3, iters_phase2=4)
    rt = tba.ba_solve(tcam.Camera.create(**CAM),
                      tba.BAProblem(**{k: torch.from_numpy(v) for k, v in
                                       arrays.items()}),
                      iters_phase1=3, iters_phase2=4)
    # the solve moved the state: the comparison is not of two seeds
    assert np.abs(np.asarray(rj.points) - arrays["points"]).max() > 1e-2
    np.testing.assert_allclose(tnp(rt.cam_pose7), np.asarray(rj.cam_pose7),
                               atol=BA_ATOL)
    np.testing.assert_allclose(tnp(rt.points), np.asarray(rj.points),
                               atol=BA_ATOL)
    np.testing.assert_allclose(float(rt.final_cost), float(rj.final_cost),
                               rtol=BA_COST_RTOL)
    np.testing.assert_array_equal(tnp(rt.obs_inlier),
                                  np.asarray(rj.obs_inlier))


def test_nanmedian_averages_middle_values():
    x = np.array([3.0, np.nan, 1.0, 4.0, 2.0, np.nan], np.float32)
    assert float(tba._nanmedian_mid(torch.from_numpy(x))) == float(
        jnp.nanmedian(jnp.asarray(x))) == 2.5


# ---------------------------------------------------------------------------
# A JAX map from a short RGB-D run, carried across
# ---------------------------------------------------------------------------

SCENE = dict(n_points=400, seed=3, width=320, height=240, fx=260, fy=260,
             cx=160, cy=120)
CFG = dict(max_keyframes=12, max_points=2048, n_features=300, n_levels=4,
           max_frames_between_kf=2, pipeline=False, loop_closing=False)


@pytest.fixture(scope="module")
def jax_run():
    """4 JAX RGB-D frames, then the next frame inserted as a keyframe but
    not yet mapped: (system, map before mapping, new slot)."""
    scene = SyntheticScene(**SCENE)
    poses, _ = orbit_trajectory(n_frames=6, radius=0.6, forward=0.05)
    cam = jcam.Camera.create(fx=260, fy=260, cx=160, cy=120, bf=40.0,
                             width=320, height=240)
    sysj = JSys(cam, JCfg(**CFG), JSensor.RGBD)
    for k, (R, t) in enumerate(poses[:5]):
        assert sysj.track_rgbd(scene.render(R, t), scene.depth_map(R, t),
                               k / 30.0) is not None
    assert sysj.n_keyframes >= 3
    st, _, slot = JT.insert_keyframe(
        sysj.cam, sysj.track_cfg, sysj.map, sysj.last_frame, jnp.int32(5),
        jnp.float32(5 / 30.0), jnp.int32(sysj.last_kf_slot))
    return sysj, st, int(slot)


def _port_map(jstate):
    return convert.map_state_from_numpy(jnp_dict(jstate), "cpu")


def test_mapping_pass_matches(jax_run):
    sysj, st, slot = jax_run
    js, (jcul, jnew, jvic, jclip) = JLM.mapping_pass(
        sysj.cam, sysj.map_cfg, st, jnp.int32(slot), do_ba=True,
        do_cull_kf=True)
    cam_t = convert.camera_from_numpy(jnp_dict(sysj.cam), "cpu")
    mcfg = TLM.MappingConfig(*sysj.map_cfg)
    ts, (tcul, tnew, tvic, tclip) = TLM.mapping_pass(
        cam_t, mcfg, _port_map(st), slot, do_ba=True, do_cull_kf=True)
    j, t = jnp_dict(js), convert.to_numpy(ts)
    assert int(tnew) == int(jnew) and int(tnew) > 0
    assert int(tcul) == int(jcul)
    np.testing.assert_array_equal(tnp(tvic), np.asarray(jvic))
    assert int(tclip) == int(jclip)
    np.testing.assert_array_equal(t["kf_valid"], j["kf_valid"])
    np.testing.assert_array_equal(t["lm_valid"], j["lm_valid"])
    v = j["lm_valid"]
    dxyz = np.abs(t["lm_xyz"][v] - j["lm_xyz"][v])
    assert np.median(dxyz) <= MAP_XYZ_MEDIAN_ATOL, np.median(dxyz)
    assert dxyz.max() <= MAP_XYZ_MAX_ATOL, dxyz.max()
    k = j["kf_valid"]
    np.testing.assert_allclose(t["kf_pose7"][k], j["kf_pose7"][k],
                               atol=MAP_POSE_ATOL)
    np.testing.assert_array_equal(t["kf_kp_point"], j["kf_kp_point"])
    # the pass did move the map
    assert np.abs(j["kf_pose7"][k] - np.asarray(st.kf_pose7)[k]).max() > 0


@pytest.mark.parametrize("stage", ["cull", "triangulate", "fuse", "refresh"])
def test_mapping_stages_exact_inputs(jax_run, stage):
    """Each pre-BA stage from the same map: integer fields equal, floats to
    f32 rounding (triangulation solves 3x3 normal equations)."""
    sysj, st, slot = jax_run
    cam_t = convert.camera_from_numpy(jnp_dict(sysj.cam), "cpu")
    mcfg = TLM.MappingConfig(*sysj.map_cfg)
    tst = _port_map(st)
    if stage == "cull":
        js, jn = JLM.cull_map_points(sysj.map_cfg, st, jnp.int32(slot))
        ts, tn = TLM.cull_map_points(mcfg, tst, slot)
    elif stage == "triangulate":
        js, jn = JLM.triangulate_with_neighbors(sysj.cam, sysj.map_cfg, st,
                                                jnp.int32(slot))
        ts, tn = TLM.triangulate_with_neighbors(cam_t, mcfg, tst, slot)
    elif stage == "fuse":
        js, jn, _ = JLM.fuse_neighbors(sysj.cam, sysj.map_cfg, st,
                                       jnp.int32(slot))
        ts, tn, _ = TLM.fuse_neighbors(cam_t, mcfg, tst, slot)
    else:
        js, jn = JLM.refresh_landmarks(sysj.map_cfg, st, jnp.int32(slot)), 0
        ts, tn = TLM.refresh_landmarks(mcfg, tst, slot), 0
    assert int(tn) == int(jn)
    rtol = TRI_RTOL if stage == "triangulate" else 0.0
    j, t = jnp_dict(js), convert.to_numpy(ts)
    for name in j:
        if j[name].dtype.kind == "f":
            np.testing.assert_allclose(t[name], j[name], rtol=rtol,
                                       atol=MAP_XYZ_ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(t[name], j[name], err_msg=name)


def test_map_state_helpers(jax_run):
    _, st, slot = jax_run
    tst = _port_map(st)
    np.testing.assert_array_equal(tnp(tst.observation_counts()),
                                  np.asarray(st.observation_counts()))
    assert int(tst.free_kf_slot()) == int(st.free_kf_slot())
    want = np.random.RandomState(0).rand(tst.F) < 0.5
    for x, y in zip(tst.allocate_points(torch.from_numpy(want)),
                    st.allocate_points(jnp.asarray(want))):
        np.testing.assert_array_equal(tnp(x), np.asarray(y))
    dead = np.asarray(st.lm_valid) & (np.arange(st.P) % 3 == 0)
    j = jnp_dict(st.remove_points(jnp.asarray(dead)))
    t = convert.to_numpy(tst.remove_points(torch.from_numpy(dead)))
    for k in ("lm_valid", "kf_kp_point"):
        np.testing.assert_array_equal(t[k], j[k])


def test_covisibility_row_counts_landmark_zero(jax_run):
    """The port marks a keyframe's landmarks with a max-scatter. The
    reference's `.set` lets masked rows write 0 over landmark 0 in an
    unspecified order (ROADMAP Q3 #6), so the two may differ only by the
    observations of landmark 0; away from it they are equal."""
    _, st, slot = jax_run
    tst = _port_map(st)
    kp = np.asarray(st.kf_kp_point)
    ok = (kp >= 0) & np.asarray(st.kf_kp_valid) & np.asarray(
        st.kf_valid)[:, None]
    for kf in np.where(np.asarray(st.kf_valid))[0]:
        mine = set(kp[kf][ok[kf]].tolist())
        # a weight counts the other keyframe's observations of my landmarks
        want = np.array([sum(p in mine for p in kp[o][ok[o]].tolist())
                         if o != kf else 0 for o in range(st.K)])
        got = tnp(tst.covisibility_row(int(kf)))
        np.testing.assert_array_equal(got, want)
        ref = np.asarray(st.covisibility_row(jnp.int32(kf)))
        sees0 = np.array([0 in set(kp[o][ok[o]].tolist())
                          for o in range(st.K)])
        np.testing.assert_array_equal(got[~sees0 | (0 not in mine)],
                                      ref[~sees0 | (0 not in mine)])


def test_create_dtypes_match_reference():
    from orb_slam2_e_tpu.models.map_state import MapState as JMap
    j = jnp_dict(JMap.create(4, 8, 16))
    t = convert.to_numpy(MapState.create(4, 8, 16, device="cpu"))
    assert j.keys() == t.keys()
    for k in j:
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
