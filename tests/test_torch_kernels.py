"""The port's fast_nms_blur: plain twin vs the reference's XLA path on the
CPU, wrapper contract, and (on a card only) the CUDA kernel vs its twin.

The JAX reference is imported inside the tests that use it, so that this
module also imports on a machine with a card and no JAX, where
`python -m pytest tests/test_torch_kernels.py -m cuda` runs the kernel
tests."""

import functools

import numpy as np
import pytest
import torch

from _torch_port import cuda_device, tnp
from orb_slam2_e_tpu_torch.ops import kernels

TH_HIGH, TH_LOW = 20.0, 7.0
# blur: XLA and torch sum the same 14 terms, but XLA may contract a
# multiply-add into an FMA; 1e-4 is ~7 f32 ulps at 255 (4.6e-5 measured
# on a CPU)
BLUR_ATOL = 1e-4
# kernel vs twin on the card: the kernel pins the twin's term order and
# rounding (__fmul_rn/__fadd_rn), measured equal on an H100; 1e-3 is the
# bound
KERNEL_BLUR_ATOL = 1e-3

SHAPES = [(480, 640), (133, 179), (37, 53)]


def _image(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.float32)


def _xla_score_nms(img):
    import jax.numpy as jnp
    from orb_slam2_e_tpu.ops import orb as jorb
    score = jorb.fast_score_map(img, TH_HIGH, TH_LOW)
    neigh = [jorb._shift2d(score, dx, dy) for dx in (-1, 0, 1)
             for dy in (-1, 0, 1) if dx or dy]
    is_max = functools.reduce(jnp.logical_and, [score >= n for n in neigh])
    return jnp.where(is_max, score, 0.0)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_xla_path_whole_image(shape):
    """Scores exactly equal over the WHOLE image, border included; blur
    within BLUR_ATOL (reflect-101 borders on both sides)."""
    import jax.numpy as jnp
    from orb_slam2_e_tpu.ops import orb as jorb
    img = _image(shape)
    score_t, blur_t = kernels.fast_nms_blur_plain(torch.from_numpy(img),
                                                  TH_HIGH, TH_LOW)
    score_j = np.asarray(_xla_score_nms(jnp.asarray(img)))
    blur_j = np.asarray(jorb.gaussian_blur7(jnp.asarray(img)))
    np.testing.assert_array_equal(tnp(score_t), score_j)
    assert (score_j > 0).sum() > 0.01 * img.size
    np.testing.assert_allclose(tnp(blur_t), blur_j, rtol=0, atol=BLUR_ATOL)


def test_wrapper_on_cpu_takes_plain_and_counts_nothing():
    img = torch.from_numpy(_image((64, 80), seed=1))
    before = kernels.fast_nms_blur.launches
    s1, b1 = kernels.fast_nms_blur(img, TH_HIGH, TH_LOW)
    s2, b2 = kernels.fast_nms_blur_plain(img, TH_HIGH, TH_LOW)
    assert torch.equal(s1, s2) and torch.equal(b1, b2)
    assert kernels.fast_nms_blur.launches == before


@pytest.mark.parametrize("bad", ["dtype", "ndim", "strided", "tiny"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    img = torch.from_numpy(_image((32, 48)))
    arg = {"dtype": img.to(torch.float64), "ndim": img[None],
           "strided": img[:, ::2], "tiny": img[:3, :3].contiguous()}[bad]
    with pytest.raises(ValueError):
        kernels.fast_nms_blur(arg, TH_HIGH, TH_LOW)


def test_gaussian_taps_match_reference():
    from orb_slam2_e_tpu.ops import orb as jorb
    np.testing.assert_array_equal(kernels.gaussian_taps7(),
                                  jorb._gaussian_kernel1d(2.0, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernel_matches_plain(shape):
    dev = cuda_device()
    img = torch.from_numpy(_image(shape, seed=2)).to(dev)
    before = kernels.fast_nms_blur.launches
    score_k, blur_k = kernels.fast_nms_blur(img, TH_HIGH, TH_LOW)
    score_p, blur_p = kernels.fast_nms_blur_plain(img, TH_HIGH, TH_LOW)
    torch.cuda.synchronize()
    assert kernels.fast_nms_blur.launches == before + 1
    assert torch.equal(score_k, score_p)
    assert (blur_k - blur_p).abs().max().item() <= KERNEL_BLUR_ATOL
