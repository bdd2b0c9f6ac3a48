"""Stereo matching: left-right ORB correspondence with SAD subpixel refine.

Port of `orb_slam2_e_tpu/ops/stereo.py` (reference
Frame::ComputeStereoMatches): per left keypoint, the best Hamming match
among right keypoints in the same row band, octave band and disparity
range; then an 11x11 SAD window slid +-5 px on the level-0 images with a
parabola for the subpixel offset, and the median-SAD outlier filter.

The right image's extractor belongs to the caller (`SlamSystem` owns one
beside the left one); there is no module-level cache.
"""

from __future__ import annotations

import torch

from . import matching
from .ba import _nanmedian_mid
from .camera import Camera
from .orb import OrbFeatures

SAD_HALF = 5          # 11x11 window (reference w=5)
SLIDE = 5             # +-5 px slide (reference L=5)


def _gather_patches(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor):
    """(F, 11, 11) patches of a (H, W) image centred at integer (cx, cy),
    coordinates clamped to the image."""
    H, W = img.shape
    off = torch.arange(-SAD_HALF, SAD_HALF + 1, device=img.device)
    yy = torch.clamp(cy[:, None, None] + off[None, :, None], 0, H - 1)
    xx = torch.clamp(cx[:, None, None] + off[None, None, :], 0, W - 1)
    return img.reshape(-1)[yy * W + xx]


def stereo_match(cam: Camera, feats_l: OrbFeatures, feats_r: OrbFeatures,
                 img_l: torch.Tensor, img_r: torch.Tensor,
                 scale_factor: float = 1.2, min_z: float = 0.1):
    """Returns (ur (F,), depth (F,)) for the left features; -1 where
    unmatched."""
    dmat = matching.hamming_matrix(matching.unpack_desc(feats_l.desc),
                                   matching.unpack_desc(feats_r.desc))
    row_tol = 2.0 * scale_factor ** feats_l.octave.to(torch.float32)
    dv = torch.abs(feats_l.uv[:, None, 1] - feats_r.uv[None, :, 1])
    max_d = cam.bf / min_z
    disp = feats_l.uv[:, None, 0] - feats_r.uv[None, :, 0]
    mask = ((dv <= row_tol[:, None]) & (disp > 0.1) & (disp < max_d)
            & matching.octave_range_mask(feats_l.octave, feats_r.octave)
            & feats_l.valid[:, None] & feats_r.valid[None, :])
    best, d1, _ = matching.masked_best2(dmat, mask)
    good = d1 <= matching.TH_HIGH
    u_r0 = feats_r.uv[torch.where(good, best, 0), 0]

    # SAD refinement around u_r0 on the level-0 images, each patch taken
    # relative to its centre pixel (reference normalises by the centre)
    il = img_l.to(torch.float32)
    ir = img_r.to(torch.float32)
    c = SAD_HALF
    cxl = torch.round(feats_l.uv[:, 0]).to(torch.int64)
    cyl = torch.round(feats_l.uv[:, 1]).to(torch.int64)
    patch_l = _gather_patches(il, cxl, cyl)
    patch_l = patch_l - patch_l[:, c:c + 1, c:c + 1]
    cxr0 = torch.round(u_r0).to(torch.int64)
    sads = []
    for s in range(-SLIDE, SLIDE + 1):
        patch_r = _gather_patches(ir, cxr0 + s, cyl)
        patch_r = patch_r - patch_r[:, c:c + 1, c:c + 1]
        sads.append(torch.abs(patch_l - patch_r).sum(dim=(1, 2)))
    sad = torch.stack(sads, dim=1)                      # (F, 11)
    best_s = torch.argmin(sad, dim=1)                   # first minimum
    # a minimum on the slide's boundary is discarded (reference :659-660)
    interior = (best_s > 0) & (best_s < 2 * SLIDE)
    ctr = torch.clamp(best_s, 1, 2 * SLIDE - 1)
    y0 = torch.gather(sad, 1, (ctr - 1)[:, None])[:, 0]
    y1 = torch.gather(sad, 1, ctr[:, None])[:, 0]
    y2 = torch.gather(sad, 1, (ctr + 1)[:, None])[:, 0]
    delta = 0.5 * (y0 - y2) / torch.clamp(y0 + y2 - 2 * y1, min=1e-6)
    delta_ok = torch.abs(delta) <= 1.0                  # reference :668-669
    u_ref = (cxr0.to(torch.float32) + (ctr - SLIDE).to(torch.float32)
             + delta)
    # disparity of the image content at the integer left window centre
    disparity = cxl.to(torch.float32) - u_ref
    ok = good & interior & delta_ok & (disparity > 0.01) & (disparity < max_d)
    # median-SAD outlier filter (reference :690-701)
    nan = torch.full_like(y1, float("nan"))
    med = _nanmedian_mid(torch.where(ok, y1, nan))
    med = torch.where(torch.isnan(med), torch.full_like(med, float("inf")),
                      med)
    ok = ok & (y1 <= 1.5 * 1.4 * med)
    neg = torch.full_like(disparity, -1.0)
    depth = torch.where(ok, cam.bf / torch.clamp(disparity, min=1e-6), neg)
    ur = torch.where(ok, feats_l.uv[:, 0] - disparity, neg)
    return ur, depth


def stereo_depth_for_features(cam: Camera, img_l, img_r,
                              feats_l: OrbFeatures, extractor,
                              scale_factor: float = 1.2) -> torch.Tensor:
    """Extract the right image with `extractor` (the left one's pyramid:
    a mismatched right pyramid finds the same corners at other octaves and
    the octave band drops them) and match. Returns depth (F,)."""
    feats_r = extractor(img_r)
    _, depth = stereo_match(cam, feats_l, feats_r, img_l, img_r, scale_factor)
    return depth
