"""The port's fast_nms_blur and fast_nms_blur_pyramid: plain twins vs the
reference's XLA path on the CPU, wrapper contract, packed-output layout, the
extractor through the pyramid entry, and (on a card only) the CUDA kernel vs
its twin.

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
# the 8 levels of a 480x640 frame at scale 1.2; shapes no tile divides
LEVEL_SHAPES = [(int(round(480 / 1.2 ** i)), int(round(640 / 1.2 ** i)))
                for i in range(8)]
ODD_SHAPES = [(4, 4), (5, 37), (67, 130)]


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


@pytest.mark.parametrize("shapes", [LEVEL_SHAPES, ODD_SHAPES],
                         ids=["levels_480x640", "odd"])
def test_pyramid_matches_one_level_and_xla_path(shapes):
    """The pyramid entry on the CPU: level by level bit-equal to the
    one-level plain version, scores equal to the XLA path and blur within
    BLUR_ATOL of it, whatever mix of shapes it is given."""
    import jax.numpy as jnp
    from orb_slam2_e_tpu.ops import orb as jorb
    imgs = [_image(shape, seed=3 + k) for k, shape in enumerate(shapes)]
    out = kernels.fast_nms_blur_pyramid([torch.from_numpy(i) for i in imgs],
                                        TH_HIGH, TH_LOW)
    assert len(out) == len(imgs)
    for img, (score_t, blur_t) in zip(imgs, out):
        score_1, blur_1 = kernels.fast_nms_blur_plain(torch.from_numpy(img),
                                                      TH_HIGH, TH_LOW)
        assert torch.equal(score_t, score_1) and torch.equal(blur_t, blur_1)
        np.testing.assert_array_equal(
            tnp(score_t), np.asarray(_xla_score_nms(jnp.asarray(img))))
        np.testing.assert_allclose(
            tnp(blur_t), np.asarray(jorb.gaussian_blur7(jnp.asarray(img))),
            rtol=0, atol=BLUR_ATOL)


@pytest.mark.parametrize("shapes", [LEVEL_SHAPES, ODD_SHAPES, [(64, 80)]],
                         ids=["levels_480x640", "odd", "one"])
def test_packed_layout_round_trips(shapes):
    """Every level is a contiguous (H, W) view of the packed buffer at a
    128-byte-aligned offset, no two levels overlap, and what is written
    through a view is read back from the buffer at the offset."""
    offsets, total = kernels.pyramid_layout(shapes)
    assert offsets[0] == 0 and all(o % 32 == 0 for o in offsets)
    ends = [o + h * w for o, (h, w) in zip(offsets, shapes)]
    assert all(e <= o for e, o in zip(ends, offsets[1:])) and ends[-1] <= total
    assert total % 32 == 0 and total - ends[-1] < 32
    packed = torch.full((total,), -1.0)
    views = kernels.pyramid_views(packed, shapes)
    for k, (view, shape) in enumerate(zip(views, shapes)):
        assert tuple(view.shape) == shape and view.is_contiguous()
        view.copy_(torch.from_numpy(_image(shape, seed=k)))
    for k, (o, shape) in enumerate(zip(offsets, shapes)):
        np.testing.assert_array_equal(
            tnp(packed[o:o + shape[0] * shape[1]]).reshape(shape),
            _image(shape, seed=k))
    covered = sum(h * w for h, w in shapes)
    assert int((packed == -1.0).sum()) == total - covered


@pytest.mark.parametrize("bad", ["none", "too_many", "mixed_dtype"])
def test_pyramid_rejects_what_the_kernel_does_not_take(bad):
    img = torch.from_numpy(_image((16, 16)))
    arg = {"none": [], "too_many": [img] * (kernels.MAX_LEVELS + 1),
           "mixed_dtype": [img, img.to(torch.float64)]}[bad]
    with pytest.raises(ValueError):
        kernels.fast_nms_blur_pyramid(arg, TH_HIGH, TH_LOW)


@pytest.mark.parametrize("kind", ["noise", "blobs", "flat"])
def test_early_reject_never_drops_a_score(kind):
    """The kernel searches for an arc only where `may_score` is True: every
    pixel with a score, in the port and in the reference, must pass it, and
    on images with flat regions it must rule most pixels out."""
    import jax.numpy as jnp
    from orb_slam2_e_tpu.ops import orb as jorb
    rng = np.random.RandomState(5)
    if kind == "noise":
        img = _image((97, 131), seed=5)
    elif kind == "blobs":
        img = np.full((97, 131), 90.0, np.float32)
        for y, x in rng.randint(8, 90, (40, 2)):
            img[y:y + rng.randint(2, 7), x:x + rng.randint(2, 7)] = \
                rng.randint(0, 256)
    else:
        img = np.full((97, 131), 90.0, np.float32)
    t = torch.from_numpy(img)
    possible = tnp(kernels.may_score(t, min(TH_HIGH, TH_LOW)))
    score_t = tnp(kernels.fast_score_map(t, TH_HIGH, TH_LOW))
    score_j = np.asarray(jorb.fast_score_map(jnp.asarray(img), TH_HIGH,
                                             TH_LOW))
    assert not (score_t != 0)[~possible].any()
    assert not (score_j != 0)[~possible].any()
    if kind == "noise":
        assert (score_t != 0).sum() > 0.05 * img.size
    else:
        assert possible.mean() < 0.5


def test_extractor_through_pyramid_entry_keeps_the_features():
    """OrbExtractor calls the pyramid entry once per extraction; its features
    equal those of the level-by-level loop over the one-level entry."""
    from orb_slam2_e_tpu_torch.ops import orb
    img0 = torch.from_numpy(_image((120, 160), seed=7))
    ex = orb.OrbExtractor(n_features=300, n_levels=4)
    got = ex(img0)
    feats = []
    for lvl, s in enumerate(ex.scales):
        img = img0 if lvl == 0 else orb.resize_bilinear(
            img0, int(round(120 / s)), int(round(160 / s))).contiguous()
        smap, blurred = kernels.fast_nms_blur(img, ex.ini_th, ex.min_th)
        uv, score, valid = orb.detect_level(smap, ex.quotas[lvl], ex.cell)
        ang = orb.orientations_from_maps(*orb.orientation_moment_maps(img),
                                         uv)
        feats.append(orb.OrbFeatures(
            uv=uv * torch.tensor(s, dtype=torch.float32), response=score,
            angle=ang, octave=torch.full((uv.shape[0],), lvl,
                                         dtype=torch.int32),
            desc=orb.compute_descriptors(blurred, uv, ang), valid=valid))
    assert int(got.valid.sum()) > 100
    for name in orb.OrbFeatures._fields:
        want = torch.cat([getattr(f, name) for f in feats])
        assert torch.equal(getattr(got, name), want), name


# 12 levels of a 1080x1920 frame: more rows of the kernel's level table
HD_SHAPES = [(int(round(1080 / 1.2 ** i)), int(round(1920 / 1.2 ** i)))
             for i in range(12)]


@pytest.mark.cuda
@pytest.mark.parametrize("th_high,th_low", [(TH_HIGH, TH_LOW), (5.0, 9.0),
                                            (20.0, 0.0)],
                         ids=["default", "high_below_low", "low_0"])
@pytest.mark.parametrize("shapes", [LEVEL_SHAPES, ODD_SHAPES, HD_SHAPES],
                         ids=["levels_480x640", "odd", "levels_1080x1920"])
def test_cuda_pyramid_matches_plain_in_one_launch(shapes, th_high, th_low):
    dev = cuda_device()
    imgs = [torch.from_numpy(_image(shape, seed=11 + k)).to(dev)
            for k, shape in enumerate(shapes)]
    # flat and smooth regions, where the early reject rules scores out
    imgs[0][: imgs[0].shape[0] // 2] = 90.0
    imgs[-1] = (imgs[-1] / 16.0).round()
    before = kernels.fast_nms_blur.launches
    got = kernels.fast_nms_blur_pyramid(imgs, th_high, th_low)
    want = kernels.fast_nms_blur_pyramid_plain(imgs, th_high, th_low)
    torch.cuda.synchronize()
    assert kernels.fast_nms_blur.launches == before + 1
    for (score_k, blur_k), (score_p, blur_p) in zip(got, want):
        assert torch.equal(score_k, score_p)
        assert (blur_k - blur_p).abs().max().item() <= KERNEL_BLUR_ATOL


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


# ---------------------------------------------------------------------------
# The batch entry: the pyramids of several lanes in one launch
# ---------------------------------------------------------------------------

def _lanes(n_lanes, shapes, seed=0):
    return [[torch.from_numpy(_image(shape, seed=seed + 100 * b + k))
             for k, shape in enumerate(shapes)] for b in range(n_lanes)]


@pytest.mark.parametrize("n_lanes", [1, 3])
def test_batch_layout_lanes_contiguous_per_level(n_lanes):
    """Level l of lane b starts right after lane b - 1's; each level's
    block of lanes starts on a 128-byte line; blocks do not overlap."""
    offsets, total = kernels.batch_layout(ODD_SHAPES, n_lanes)
    end = 0
    for (h, w), lane_offsets in zip(ODD_SHAPES, offsets):
        assert lane_offsets[0] % 32 == 0 and lane_offsets[0] >= end
        assert lane_offsets == [lane_offsets[0] + b * h * w
                                for b in range(n_lanes)]
        end = lane_offsets[-1] + h * w
    assert end <= total and total % 32 == 0


def test_batch_on_cpu_takes_plain_lane_by_lane():
    lanes = _lanes(3, ODD_SHAPES)
    before = kernels.fast_nms_blur.launches
    got = kernels.fast_nms_blur_batch(lanes, TH_HIGH, TH_LOW)
    assert kernels.fast_nms_blur.launches == before
    for b, levels in enumerate(lanes):
        want = kernels.fast_nms_blur_pyramid_plain(levels, TH_HIGH, TH_LOW)
        for (score, blur), (ws, wb) in zip(got, want):
            assert torch.equal(score[b], ws) and torch.equal(blur[b], wb)


@pytest.mark.parametrize("bad", ["shapes_differ", "too_many"])
def test_batch_rejects_what_the_kernel_does_not_take(bad):
    lanes = {"shapes_differ": [_lanes(1, ODD_SHAPES)[0],
                               _lanes(1, ODD_SHAPES[:2])[0]],
             "too_many": _lanes(2, [(4, 4)] * (kernels.MAX_LEVELS + 1))}[bad]
    with pytest.raises(ValueError):
        kernels.fast_nms_blur_batch(lanes, TH_HIGH, TH_LOW)


def test_batch_past_the_level_table_keeps_every_lane():
    """33 lanes x 2 levels overflow the 64-row level table: on the card the
    entry launches once per group of 32 lanes; on the CPU every lane still
    equals its own plain pyramid."""
    lanes = _lanes(kernels.MAX_LEVELS // 2 + 1, [(6, 7), (5, 5)], seed=9)
    got = kernels.fast_nms_blur_batch(lanes, TH_HIGH, TH_LOW)
    assert [tuple(s.shape) for s, _ in got] == [(33, 6, 7), (33, 5, 5)]
    for b, levels in enumerate(lanes):
        want = kernels.fast_nms_blur_pyramid_plain(levels, TH_HIGH, TH_LOW)
        for (score, blur), (ws, wb) in zip(got, want):
            assert torch.equal(score[b], ws) and torch.equal(blur[b], wb)


@pytest.mark.cuda
def test_cuda_batch_of_8_pyramids_in_one_launch():
    """8 lanes x 8 levels of 480x640 frames (the kernel's 64-level table
    full): one launch, each lane equal to the plain twin and to its own
    one-pyramid launch."""
    dev = cuda_device()
    lanes = [[img.to(dev) for img in levels]
             for levels in _lanes(8, LEVEL_SHAPES, seed=5)]
    before = kernels.fast_nms_blur.launches
    got = kernels.fast_nms_blur_batch(lanes, TH_HIGH, TH_LOW)
    torch.cuda.synchronize()
    assert kernels.fast_nms_blur.launches == before + 1
    assert len(lanes) * len(LEVEL_SHAPES) == kernels.MAX_LEVELS
    for b, levels in enumerate(lanes):
        want = kernels.fast_nms_blur_pyramid_plain(levels, TH_HIGH, TH_LOW)
        one = kernels.fast_nms_blur_pyramid(levels, TH_HIGH, TH_LOW)
        torch.cuda.synchronize()
        for (score, blur), (ws, wb), (os_, ob) in zip(got, want, one):
            assert torch.equal(score[b], ws) and torch.equal(score[b], os_)
            assert (blur[b] - wb).abs().max().item() <= KERNEL_BLUR_ATOL
            assert torch.equal(blur[b], ob)


@pytest.mark.cuda
def test_cuda_batch_past_the_level_table_launches_per_group():
    """9 lanes x 8 levels: two launches (8 lanes, then 1), each lane equal
    to its own one-pyramid launch."""
    dev = cuda_device()
    lanes = [[img.to(dev) for img in levels]
             for levels in _lanes(9, LEVEL_SHAPES, seed=6)]
    before = kernels.fast_nms_blur.launches
    got = kernels.fast_nms_blur_batch(lanes, TH_HIGH, TH_LOW)
    torch.cuda.synchronize()
    assert kernels.fast_nms_blur.launches == before + 2
    for b, levels in enumerate(lanes):
        one = kernels.fast_nms_blur_pyramid(levels, TH_HIGH, TH_LOW)
        torch.cuda.synchronize()
        for (score, blur), (os_, ob) in zip(got, one):
            assert torch.equal(score[b], os_) and torch.equal(blur[b], ob)
