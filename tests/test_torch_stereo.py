"""The port's stereo path against the reference (CPU): the row-band matcher
with SAD refinement on tests/test_stereo.py's pair, the rectification maps
and remap of tests/test_rectify.py, and the stereo slice end to end on
tests/test_stereo.py's `stereo_run` scene."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from _torch_port import jnp_dict, tnp
from test_stereo import BF, CX_, CY_, FX, FY, H, W, _stereo_pair
from orb_slam2_e_tpu.models.system import (SlamSystem as JSys,
                                           SystemConfig as JCfg,
                                           Sensor as JSensor)
from orb_slam2_e_tpu.ops import camera as jcam
from orb_slam2_e_tpu.ops import orb as jorb
from orb_slam2_e_tpu.ops import stereo as jstereo
from orb_slam2_e_tpu.utils import rectify as jrect
from orb_slam2_e_tpu_torch.models.system import (SlamSystem, SystemConfig,
                                                 Sensor, TrackState)
from orb_slam2_e_tpu_torch.ops import stereo as tstereo
from orb_slam2_e_tpu_torch.ops.camera import Camera
from orb_slam2_e_tpu_torch.utils import convert
from orb_slam2_e_tpu_torch.utils import rectify as trect
from orb_slam2_e_tpu_torch.utils.synthetic import (SyntheticScene,
                                                   orbit_trajectory)
from orb_slam2_e_tpu_torch.utils.trajectory import ate_rmse

# stereo_match from equal features: the Hamming match and the integer SAD
# slide are exact; a subpixel parabola or median-SAD gate right at its
# bound may fall the other way. Measured: 451 and 452 matches of 600, one
# feature differs in validity, depth within 1.7e-6 relative.
VALID_AGREE = 0.99
DEPTH_RTOL = 1e-4
REMAP_ATOL = 1e-4           # bilinear weights in f32 in both packages
# the reference's own e2e gates (tests/test_stereo.py) and the RGB-D e2e
# bounds of port vs reference centres (tests/test_torch_e2e_rgbd.py).
# Measured: 10/10 tracked in both, SE3 ATE 0.0092 m (reference 0.0070),
# 10 keyframes (reference 9), centres median 0.0053 m, max 0.0117 m.
ATE_MAX = 0.08
CENTER_MEDIAN_ATOL = 0.02
CENTER_MAX_ATOL = 0.05
CAM = dict(fx=FX, fy=FY, cx=CX_, cy=CY_, bf=BF, width=W, height=H)


def test_stereo_match_matches_reference():
    scene = SyntheticScene(n_points=400, seed=3, width=W, height=H, fx=FX,
                           fy=FY, cx=CX_, cy=CY_)
    img_l, img_r = _stereo_pair(scene, np.eye(3, dtype=np.float32),
                                np.zeros(3, np.float32))
    ex = jorb.OrbExtractor(n_features=600, n_levels=4, use_pallas=False)
    il, ir = (jnp.asarray(x, jnp.float32) for x in (img_l, img_r))
    fl, fr = ex(il), ex(ir)
    cam_j = jcam.Camera.create(**CAM)
    ur_j, d_j = (np.asarray(x) for x in jstereo.stereo_match(
        cam_j, fl, fr, il, ir))
    ur_t, d_t = (tnp(x) for x in tstereo.stereo_match(
        convert.camera_from_numpy(jnp_dict(cam_j), "cpu"),
        convert.features_from_numpy(jnp_dict(fl), "cpu"),
        convert.features_from_numpy(jnp_dict(fr), "cpu"),
        torch.from_numpy(img_l), torch.from_numpy(img_r)))
    vj, vt = d_j > 0, d_t > 0
    assert vj.sum() > 100
    assert (vj == vt).mean() >= VALID_AGREE, (vj != vt).sum()
    both = vj & vt
    np.testing.assert_allclose(d_t[both], d_j[both], rtol=DEPTH_RTOL)
    np.testing.assert_allclose(ur_t[both], ur_j[both], rtol=DEPTH_RTOL)


def test_right_extractor_is_the_left_ones_pyramid():
    """The system's right-image extractor: the left extractor's capacity
    and pyramid (as the reference's stereo_depth_for_features builds it)."""
    st = SlamSystem(Camera.create(**CAM),
                    SystemConfig(n_features=600, n_levels=4, pipeline=False,
                                 loop_closing=False, max_keyframes=8,
                                 max_points=1024), Sensor.STEREO,
                    device="cpu")
    left, right = st.extractor, st.right_extractor
    assert right is not left
    assert (right.n_features, right.scale_factor, right.n_levels) == (
        left.capacity, left.scale_factor, left.n_levels)
    assert right.quotas == left.quotas


RECTIFY_CASES = {
    "identity": (np.array([[400.0, 0, 160], [0, 400, 120], [0, 0, 1]]),
                 np.zeros(5), np.eye(3), None, 320, 240),
    "euroc": (np.array([[458.654, 0, 367.215], [0, 457.296, 248.375],
                        [0, 0, 1]]),
              np.array([-0.28340811, 0.07395907, 0.00019359,
                        1.76187114e-05]),
              np.eye(3),
              np.array([[435.2, 0, 367.45, 0], [0, 435.2, 252.2, 0],
                        [0, 0, 1, 0]]), 752, 480),
}


@pytest.mark.parametrize("case", sorted(RECTIFY_CASES))
def test_rectify_and_remap_match_reference(case):
    K, D, R, P, w, h = RECTIFY_CASES[case]
    P = K.copy() if P is None else P
    mp_j = jrect.rectify_map(K, D, R, P, w, h)
    mp_t = trect.rectify_map(K, D, R, P, w, h)
    np.testing.assert_array_equal(mp_t, mp_j)     # the same numpy code
    img = (np.random.RandomState(0).rand(h, w) * 255).astype(np.float32)
    out_j = np.asarray(jrect.remap_bilinear(jnp.asarray(img),
                                            jnp.asarray(mp_j)))
    out_t = tnp(trect.remap_bilinear(torch.from_numpy(img),
                                     torch.from_numpy(mp_t)))
    np.testing.assert_allclose(out_t, out_j, atol=REMAP_ATOL)
    rect = trect.StereoRectifier(K, D, R, P, K, D, R, P, w, h,
                                 device="cpu")
    l, r = rect(img, img.astype(np.uint8))
    np.testing.assert_allclose(tnp(l), out_j, atol=REMAP_ATOL)
    assert r.dtype == torch.float32 and r.shape == (h, w)


# ---------------------------------------------------------------------------
# The stereo slice end to end
# ---------------------------------------------------------------------------

def _centre(pose):
    if pose is None:
        return None
    R, t = (np.asarray(x, np.float64) for x in pose)
    return -R.T @ t


@pytest.fixture(scope="module")
def runs():
    scene = SyntheticScene(n_points=500, seed=2, width=W, height=H, fx=FX,
                           fy=FY, cx=CX_, cy=CY_)
    poses, centers = orbit_trajectory(n_frames=10, radius=0.9, forward=0.04)
    cfg = dict(max_keyframes=32, max_points=8192, n_features=600,
               n_levels=4, max_frames_between_kf=4, pipeline=False,
               loop_closing=False)
    sj = JSys(jcam.Camera.create(**CAM), JCfg(**cfg), JSensor.STEREO)
    st = SlamSystem(Camera.create(**CAM), SystemConfig(**cfg), Sensor.STEREO,
                    device="cpu")
    out = {"jax": (sj, []), "torch": (st, [])}
    for k, (R, t) in enumerate(poses):
        img_l, img_r = _stereo_pair(scene, R, t)
        out["jax"][1].append(_centre(sj.track_stereo(img_l, img_r,
                                                     k / 30.0)))
        out["torch"][1].append(_centre(st.track_stereo(img_l, img_r,
                                                       k / 30.0)))
    return out, centers


@pytest.mark.e2e
def test_port_passes_the_reference_gates(runs):
    out, centers = runs
    st, cen = out["torch"]
    assert sum(c is not None for c in cen) >= len(centers) - 1
    assert st.get_tracking_state() == TrackState.OK
    _, _, twc = st.get_trajectory()
    assert np.isfinite(twc).all()
    assert ate_rmse(twc, centers[-len(twc):], with_scale=False) < ATE_MAX


@pytest.mark.e2e
def test_port_agrees_with_reference(runs):
    out, _ = runs
    (sj, cj), (st, ct) = out["jax"], out["torch"]
    both = [(a, b) for a, b in zip(cj, ct) if a is not None and b is not None]
    assert len(both) >= len(cj) - 1
    d = np.array([np.linalg.norm(a - b) for a, b in both])
    assert np.median(d) < CENTER_MEDIAN_ATOL, d
    assert d.max() < CENTER_MAX_ATOL, d
