"""The port's ORB extractor against the reference (CPU, XLA path)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from _torch_port import jnp_dict, tnp
from orb_slam2_e_tpu.ops import orb as jorb
from orb_slam2_e_tpu_torch.ops import orb as torb
from orb_slam2_e_tpu_torch.utils.synthetic import (SyntheticScene,
                                                   orbit_trajectory)

W, H, N_FEATURES, N_LEVELS = 320, 240, 300, 4
ANGLE_ATOL = 1e-4        # atan2 of bit-equal moments: a few f32 ulps
DESC_SAME_MIN = 0.99     # level 0: share of valid keypoints, identical desc
OVERLAP_MIN = 0.97       # levels >= 1: shared keypoint positions
# pyramid levels: the port applies JAX's resize weights as two f32 matmuls;
# XLA's CPU dot sums in another order (<= 4.3e-4 measured at 480x360)
RESIZE_ATOL = 5e-3


def _images():
    scene = SyntheticScene(n_points=400, seed=1, width=W, height=H, fx=260,
                           fy=260, cx=160, cy=120)
    poses, _ = orbit_trajectory(n_frames=3)
    rendered = scene.render(*poses[1]).astype(np.uint8)
    noise = np.random.RandomState(0).randint(0, 256, (H, W)).astype(np.uint8)
    return {"rendered": rendered, "noise": noise}


@pytest.fixture(scope="module")
def features():
    out = {}
    for name, img in _images().items():
        fj = jorb.OrbExtractor(N_FEATURES, 1.2, N_LEVELS, use_pallas=False)(
            jnp.asarray(img))
        ft = torb.OrbExtractor(N_FEATURES, 1.2, N_LEVELS)(
            torch.from_numpy(img))
        out[name] = (jnp_dict(fj), {k: tnp(v) for k, v in
                                    ft._asdict().items()})
    return out


KINDS = ["rendered", "noise"]


@pytest.mark.parametrize("kind", KINDS)
def test_level0_keypoints_equal(features, kind):
    fj, ft = features[kind]
    lvl0 = fj["octave"] == 0
    np.testing.assert_array_equal(ft["octave"], fj["octave"])
    for k in ("uv", "response", "valid"):
        np.testing.assert_array_equal(ft[k][lvl0], fj[k][lvl0], err_msg=k)
    assert fj["valid"][lvl0].sum() > 50


@pytest.mark.parametrize("kind", KINDS)
def test_level0_angles_and_descriptors(features, kind):
    fj, ft = features[kind]
    v = fj["valid"] & (fj["octave"] == 0)
    np.testing.assert_allclose(ft["angle"][v], fj["angle"][v], rtol=0,
                               atol=ANGLE_ATOL)
    same = (ft["desc"][v] == fj["desc"][v]).all(axis=1).mean()
    assert same >= DESC_SAME_MIN, same


@pytest.mark.parametrize("kind", KINDS)
def test_upper_levels_keypoint_overlap(features, kind):
    fj, ft = features[kind]
    for lvl in range(1, N_LEVELS):
        def kps(f):
            m = (f["octave"] == lvl) & f["valid"]
            return {tuple(u) for u in f["uv"][m]}
        a, b = kps(fj), kps(ft)
        assert len(a & b) >= OVERLAP_MIN * max(len(a), 1), (lvl, len(a),
                                                            len(b))


def test_pattern_bit_identical():
    np.testing.assert_array_equal(torb._PATTERN, jorb._PATTERN)
    assert torb._PATTERN.dtype == jorb._PATTERN.dtype


@pytest.mark.parametrize("cfg", [(1000, 1.2, 8), (600, 1.2, 4), (300, 1.1, 6)])
def test_level_quotas(cfg):
    assert torb.level_quotas(*cfg) == jorb.level_quotas(*cfg)


@pytest.mark.parametrize("n", [16, 53, 179, 480, 640, 1000])
def test_cumsum_rows_is_xla_cpu_cumsum(n):
    """The moment maps' scan reproduces XLA's CPU cumsum bit for bit."""
    rng = np.random.RandomState(n)
    x = (rng.uniform(0, 255, (3, n)) * rng.uniform(0, n, (1, n))).astype(
        np.float32)
    np.testing.assert_array_equal(
        tnp(torb.cumsum_rows(torch.from_numpy(x))),
        np.asarray(jnp.cumsum(jnp.asarray(x), axis=1)))


def test_moment_maps_bit_equal():
    img = _images()["rendered"].astype(np.float32)
    m10j, m01j = jorb.orientation_moment_maps(jnp.asarray(img))
    m10t, m01t = torb.orientation_moment_maps(torch.from_numpy(img))
    np.testing.assert_array_equal(tnp(m10t), np.asarray(m10j))
    np.testing.assert_array_equal(tnp(m01t), np.asarray(m01j))


@pytest.mark.parametrize("out_hw", [(200, 267), (167, 222), (139, 185)])
def test_resize_matches_jax_image_resize(out_hw):
    img = _images()["rendered"].astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), out_hw,
                                      method="bilinear"))
    got = tnp(torb.resize_bilinear(torch.from_numpy(img), *out_hw))
    np.testing.assert_allclose(got, ref, rtol=0, atol=RESIZE_ATOL)


def test_top_k_tie_order_is_lax_top_k():
    x = np.array([3, 5, 5, 1, 5, 2, 5, 0, 3], np.float32)
    vals, idx = torb.top_k(torch.from_numpy(x), 6)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 6)
    np.testing.assert_array_equal(tnp(idx), np.asarray(ji))
    np.testing.assert_array_equal(tnp(vals), np.asarray(jv))
