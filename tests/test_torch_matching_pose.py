"""The port's Lie algebra, camera, matching and pose LM against the
reference on the same numpy inputs (CPU)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from _torch_port import tnp
from orb_slam2_e_tpu.ops import camera as jcam
from orb_slam2_e_tpu.ops import lie as jlie
from orb_slam2_e_tpu.ops import matching as jm
from orb_slam2_e_tpu.ops import pose_opt as jpo
from orb_slam2_e_tpu_torch.ops import camera as tcam
from orb_slam2_e_tpu_torch.ops import lie as tlie
from orb_slam2_e_tpu_torch.ops import matching as tm
from orb_slam2_e_tpu_torch.ops import pose_opt as tpo

LIE_ATOL = 1e-5          # f32 elementwise formulas, a few ulps
POSE_ATOL = 1e-4         # 4x10 LM iterations in f32 from equal inputs
PIX_ATOL = 1e-3          # undistortion fixed point, f32, pixels


def _t(x):
    return torch.from_numpy(np.array(x))


def _rotvecs(seed, n=64):
    rng = np.random.RandomState(seed)
    w = rng.randn(n, 3).astype(np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    # small angles, generic ones and ones near pi
    ang = np.concatenate([rng.uniform(0, 1e-4, n // 4),
                          rng.uniform(0.1, 3.0, n // 2),
                          rng.uniform(3.1, 3.14, n - n // 4 - n // 2)])
    return (w * ang[:, None]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_so3_exp_log_quat(seed):
    w = _rotvecs(seed)
    Rj = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    Rt = tnp(tlie.so3_exp(_t(w)))
    np.testing.assert_allclose(Rt, Rj, atol=LIE_ATOL)
    np.testing.assert_allclose(tnp(tlie.so3_log(_t(Rj))),
                               np.asarray(jlie.so3_log(jnp.asarray(Rj))),
                               atol=1e-3)   # arccos near pi: ~sqrt(ulp)
    qj = np.asarray(jlie.quat_from_mat(jnp.asarray(Rj)))
    np.testing.assert_allclose(tnp(tlie.quat_from_mat(_t(Rj))), qj,
                               atol=LIE_ATOL)
    np.testing.assert_allclose(tnp(tlie.mat_from_quat(_t(qj))),
                               np.asarray(jlie.mat_from_quat(jnp.asarray(qj))),
                               atol=LIE_ATOL)


def test_se3_and_pose7():
    rng = np.random.RandomState(3)
    xi = (rng.randn(32, 6) * 0.5).astype(np.float32)
    p = rng.randn(32, 3).astype(np.float32)
    Rj, tj = jlie.se3_exp(jnp.asarray(xi))
    Rt, tt = tlie.se3_exp(_t(xi))
    np.testing.assert_allclose(tnp(Rt), np.asarray(Rj), atol=LIE_ATOL)
    np.testing.assert_allclose(tnp(tt), np.asarray(tj), atol=LIE_ATOL)
    p7j = np.asarray(jlie.pose7_pack(Rj, tj))
    np.testing.assert_allclose(tnp(tlie.pose7_pack(Rt, tt)), p7j,
                               atol=LIE_ATOL)
    Ru, tu = tlie.pose7_unpack(_t(p7j))
    np.testing.assert_allclose(tnp(tlie.se3_apply(Ru, tu, _t(p))),
                               np.asarray(jlie.se3_apply(
                                   *jlie.pose7_unpack(jnp.asarray(p7j)),
                                   jnp.asarray(p))), atol=1e-4)
    Ri, ti = tlie.se3_inverse(*tlie.se3_compose(Rt, tt, Ru, tu))
    Rji, tji = jlie.se3_inverse(*jlie.se3_compose(
        Rj, tj, *jlie.pose7_unpack(jnp.asarray(p7j))))
    np.testing.assert_allclose(tnp(Ri), np.asarray(Rji), atol=LIE_ATOL)
    np.testing.assert_allclose(tnp(ti), np.asarray(tji), atol=1e-4)
    np.testing.assert_array_equal(tnp(tlie.pose7_identity((2,), device="cpu")),
                                  np.asarray(jlie.pose7_identity((2,))))


def test_camera_undistort_project_backproject():
    kw = dict(fx=410.0, fy=405.0, cx=240.5, cy=181.0, k1=0.12, k2=-0.2,
              p1=1e-3, p2=-2e-3, k3=0.05, bf=40.0, width=480, height=360)
    cj, ct = jcam.Camera.create(**kw), tcam.Camera.create(**kw)
    np.testing.assert_array_equal(tnp(ct.K), np.asarray(cj.K))
    rng = np.random.RandomState(4)
    uv = rng.uniform([0, 0], [480, 360], (200, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tnp(tcam.undistort_pixels(ct, _t(uv))),
        np.asarray(jcam.undistort_pixels(cj, jnp.asarray(uv))),
        atol=PIX_ATOL)
    xc = np.concatenate([rng.uniform(-3, 3, (200, 2)),
                         rng.uniform(-1, 9, (200, 1))], 1).astype(np.float32)
    uvj, zj = jcam.project(cj, jnp.asarray(xc))
    uvt, zt = tcam.project(ct, _t(xc))
    np.testing.assert_allclose(tnp(uvt), np.asarray(uvj), rtol=1e-6)
    np.testing.assert_array_equal(tnp(tcam.in_image(ct, uvt)),
                                  np.asarray(jcam.in_image(cj, uvj)))
    np.testing.assert_allclose(
        tnp(tcam.backproject(ct, uvt, zt)),
        np.asarray(jcam.backproject(cj, uvj, zj)), rtol=1e-6, atol=1e-6)


def _descs(rng, n):
    return rng.randint(0, 256, (n, 32)).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hamming_and_best2_exact_with_ties(seed):
    rng = np.random.RandomState(seed)
    # few distinct descriptors -> many equal distances (ties)
    base = _descs(rng, 6)
    a = base[rng.randint(0, 6, 40)]
    b = base[rng.randint(0, 6, 70)]
    dj = jm.hamming_matrix(jm.unpack_desc(jnp.asarray(a)),
                           jm.unpack_desc(jnp.asarray(b)))
    dt = tm.hamming_matrix(tm.unpack_desc(_t(a)), tm.unpack_desc(_t(b)))
    np.testing.assert_array_equal(tnp(dt), np.asarray(dj))
    mask = rng.rand(40, 70) < 0.3
    mask[0] = False            # a row with no candidate
    mask[1] = False
    mask[1, 5] = True          # a row with one candidate
    for x, y in zip(tm.masked_best2(dt, _t(mask)),
                    jm.masked_best2(dj, jnp.asarray(mask))):
        np.testing.assert_array_equal(tnp(x), np.asarray(y))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resolve_duplicates_exact(seed):
    rng = np.random.RandomState(seed)
    idx = rng.randint(-1, 12, 80).astype(np.int32)
    dist = rng.randint(0, 4, 80).astype(np.int32)
    np.testing.assert_array_equal(
        tnp(tm.resolve_duplicates(_t(idx), _t(dist), 12)),
        np.asarray(jm.resolve_duplicates(jnp.asarray(idx), jnp.asarray(dist),
                                         12)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rotation_consistency_exact_with_ties(seed):
    rng = np.random.RandomState(seed)
    n = 90
    # angles on a few bin centres -> equal histogram counts (ties)
    bins = rng.choice(6, n)
    a = ((bins + 0.5) * 2 * np.pi / 30 + rng.uniform(-3, 3, n).round()
         * 2 * np.pi).astype(np.float32)
    b = rng.uniform(-1e-3, 1e-3, n).astype(np.float32)
    valid = rng.rand(n) < 0.8
    got = tm.rotation_consistency_mask(_t(a), _t(b), _t(valid))
    ref = jm.rotation_consistency_mask(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(valid))
    np.testing.assert_array_equal(tnp(got), np.asarray(ref))
    # fewer than min_pairs valid pairs: pass-through
    few = valid & (np.arange(n) < 10)
    np.testing.assert_array_equal(
        tnp(tm.rotation_consistency_mask(_t(a), _t(b), _t(few))),
        np.asarray(jm.rotation_consistency_mask(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(few))))


def test_window_and_octave_masks():
    rng = np.random.RandomState(5)
    uq = rng.uniform(0, 100, (30, 2)).astype(np.float32)
    ut = rng.uniform(0, 100, (50, 2)).astype(np.float32)
    r = rng.uniform(5, 20, 30).astype(np.float32)
    np.testing.assert_array_equal(
        tnp(tm.window_mask(_t(uq), _t(ut), _t(r))),
        np.asarray(jm.window_mask(jnp.asarray(uq), jnp.asarray(ut),
                                  jnp.asarray(r))))
    oq = rng.randint(0, 8, 30).astype(np.int32)
    ot = rng.randint(0, 8, 50).astype(np.int32)
    np.testing.assert_array_equal(
        tnp(tm.octave_range_mask(_t(oq), _t(ot))),
        np.asarray(jm.octave_range_mask(jnp.asarray(oq), jnp.asarray(ot))))


def _pose_problem(seed):
    """Noisy projections of random points, 10% gross outliers, half of the
    features with a stereo coordinate, and a perturbed initial pose."""
    rng = np.random.RandomState(seed)
    n = 300
    fx, fy, cx, cy, bf = 400.0, 400.0, 240.0, 180.0, 40.0
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.05, -0.1, 0.02])))
    t = np.array([0.1, -0.05, 0.2], np.float32)
    xyz = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(4, 9, n)], 1).astype(np.float32)
    xc = xyz @ R.T + t
    u = fx * xc[:, 0] / xc[:, 2] + cx
    v = fy * xc[:, 1] / xc[:, 2] + cy
    ur = u - bf / xc[:, 2]
    uvr = np.stack([u, v, ur], 1) + rng.randn(n, 3) * 0.7
    uvr[rng.rand(n) < 0.5, 2] = -1.0                     # mono features
    out = rng.rand(n) < 0.1
    uvr[out, :2] += rng.uniform(-40, 40, (out.sum(), 2))
    octave = rng.randint(0, 4, n)
    inv_sigma2 = (1.0 / 1.2 ** (2 * octave)).astype(np.float32)
    valid = rng.rand(n) < 0.95
    R0 = np.asarray(jlie.so3_exp(jnp.asarray([0.06, -0.08, 0.0]))
                    ).astype(np.float32)
    t0 = (t + np.array([0.05, 0.03, -0.08])).astype(np.float32)
    cam = dict(fx=fx, fy=fy, cx=cx, cy=cy, bf=bf, width=480, height=360)
    return cam, R0, t0, (uvr.astype(np.float32), xyz, inv_sigma2, valid)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pose_optimize_matches(seed):
    cam, R0, t0, obs = _pose_problem(seed)
    Rj, tj, inl_j, n_j = jpo.pose_optimize(
        jcam.Camera.create(**cam), jnp.asarray(R0), jnp.asarray(t0),
        jpo.PoseObs(*(jnp.asarray(o) for o in obs)))
    Rt, tt, inl_t, n_t = tpo.pose_optimize(
        tcam.Camera.create(**cam), _t(R0), _t(t0),
        tpo.PoseObs(*(_t(o) for o in obs)))
    np.testing.assert_allclose(tnp(Rt), np.asarray(Rj), atol=POSE_ATOL)
    np.testing.assert_allclose(tnp(tt), np.asarray(tj), atol=POSE_ATOL)
    assert int(n_t) == int(n_j)
    np.testing.assert_array_equal(tnp(inl_t), np.asarray(inl_j))
