"""The benchmark's own arithmetic at hand-worked values: the JAX check by
whole top-level names, the ATE, the roofline bounds, the trace arithmetic,
the percentile and the PNG reader of the scene generator."""

import numpy as np
import pytest
import torch

from slambench import harness
from slambench.reference import geometry, roofline, trace
from slambench.scenes import render, sequences


@pytest.mark.parametrize("name,bad", [
    ("orb_slam2_e_tpu_torch", False), ("orb_slam2_e_tpu_torch.ops.orb", False),
    ("jaxtyping", False), ("numpy", False), ("orb_slam2_e_tpu", True),
    ("orb_slam2_e_tpu.ops.orb", True), ("jax", True), ("jax.numpy", True),
    ("jaxlib.xla_client", True), ("flax.linen", True)])
def test_forbidden_modules_whole_top_level_names(name, bad):
    assert harness.forbidden_modules([name]) == ([name] if bad else [])


def test_ate_of_a_rigid_copy_is_zero():
    rng = np.random.RandomState(0)
    gt = rng.randn(20, 3)
    R = sequences.so3_exp([0.3, -0.2, 0.5])
    est = gt @ R.T + np.array([1.0, -2.0, 0.5])
    assert geometry.ate_rmse(est, gt) < 1e-12


def test_ate_at_hand_worked_value():
    # two points 2 apart, the estimate 4 apart: aligned about the mean,
    # each off by 1
    gt = np.array([[-1.0, 0, 0], [1.0, 0, 0]])
    est = np.array([[-2.0, 0, 0], [2.0, 0, 0]])
    assert geometry.ate_rmse(est, gt) == pytest.approx(1.0)


def test_fast_nms_blur_bound():
    # 1e6 px: bytes 12e6 / 3.35e12 = 3.582e-6 s; operations 46e6 + 1e5 *
    # 177 + 1e4 * 16 = 63.86e6 / 33.5e12 = 1.906e-6 s: bytes bind
    c = {"pixels": 10 ** 6, "score_possible": 10 ** 5, "score_not_0": 10 ** 4}
    assert roofline.fast_nms_blur_bound_s(c) == pytest.approx(12e6 / 3.35e12)
    c["score_possible"] = 10 ** 6       # now 223e6 operations bind
    assert roofline.fast_nms_blur_bound_s(c) == pytest.approx(
        (46e6 + 177e6 + 16e4) / 33.5e12)


def test_fast_nms_blur_counts_on_a_corner():
    img = torch.zeros((20, 20))
    img[8:, 8:] = 100.0
    c = roofline.fast_nms_blur_counts([img], 20.0, 7.0)
    assert c["pixels"] == 400
    assert 0 < c["score_not_0"] <= c["score_possible"] < 400


def test_segment_sum_bound():
    # 6000 live rows x 18 into 131072 segments: bytes 432000 + 48000 +
    # 1048584 + 9437184 = 10965768 / 3.35e12
    assert roofline.segment_sum_bound_s(131072, 18, 6000) == pytest.approx(
        10965768 / 3.35e12)
    assert roofline.live_rows(torch.tensor([0, 3, 3, 1]), 3) == 2


def test_union_and_events():
    assert trace.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    ev = trace.Events(
        device=[("k1", 0.0, 2.0), ("Memcpy HtoD", 1.0, 3.0),
                ("fast_nms_blur_kernel", 5.0, 6.0)],
        host=[("slambench.track", 0.0, 10.0), ("cudaLaunchKernel", 1.0, 1.1),
              ("cudaLaunchKernel", 11.0, 11.1), ("cudaStreamSynchronize",
                                                 3.0, 5.0)])
    assert ev.busy_us() == 4
    assert len(ev.kernels()) == 2
    assert ev.count_host(trace.SYNC_CALLS) == 1
    assert ev.count_host_within(trace.LAUNCH_CALLS, ev.spans("track")) == 1
    assert ev.kernel_seconds("fast_nms_blur") == pytest.approx([1e-6])
    # the device idles over (3, 5), the host in the synchronize, and over
    # (6, 10), the host in the span alone
    gaps = ev.idle_gaps(0.0, 10.0, 2)
    assert [g[0] for g in gaps] == ["track/host",
                                    "track/cudaStreamSynchronize"]
    assert [g[1] for g in gaps] == pytest.approx([4e-6, 2e-6])


def test_percentile():
    assert harness.percentile(list(range(11)), 90) == pytest.approx(9.0)
    assert harness.percentile([1.0, 2.0], 90) == pytest.approx(1.9)


def test_png_reader_and_textures():
    img = render.read_grey_png(render.SAMPLE_DATA / "grace_hopper.png")
    assert img.shape == (600, 512) and img.dtype == np.uint8
    texs = render.load_textures()
    assert len(texs) == 4 and all(min(t.shape) > render.TILE for t in texs)


def test_periodic_motion_wraps():
    motion = {"period_frames": 10, "base": [0, 0, 1, 0, 0, 0],
              "terms": [{"axis": "x", "amp": 0.2, "k": 1},
                        {"axis": "ry", "amp": 0.1, "k": 2, "phase": 0.5}]}
    _, c0 = sequences.harmonic_poses(motion, 1, first=0)
    _, c10 = sequences.harmonic_poses(motion, 1, first=10)
    assert np.allclose(c0, c10)


def test_raw_dirs_invert_the_distortion():
    K = [[200.0, 0, 80], [0, 200, 60], [0, 0, 1]]
    D = [0.2624, -0.9531, -0.0054, 0.0026, 1.1633]
    d = sequences.raw_dirs(160, 120, K, D)
    xd, yd = sequences.distort(d[..., 0], d[..., 1], D)
    u, v = np.meshgrid(np.arange(160.0), np.arange(120.0))
    assert np.abs(xd * 200 + 80 - u).max() < 1e-9
    assert np.abs(yd * 200 + 60 - v).max() < 1e-9
