"""The plain stereo front end: rectification of a raw pair and the
left-right matcher, in plain torch.

`rectify_map` / `remap` follow OpenCV's initUndistortRectifyMap (pinhole
and radial-tangential distortion) and remap (bilinear, border 0).
`stereo_depth` is ORB-SLAM2's Frame::ComputeStereoMatches as the port
computes it (`orb_slam2_e_tpu_torch/ops/stereo.py`, frozen here): per left
keypoint the best Hamming match among right keypoints in its row band,
octave band and disparity range, an 11x11 SAD window slid +-5 px on the
level-0 images with a parabola for the subpixel offset, and the median-SAD
outlier filter. `dtype` is the precision of the remap, the SAD and the
disparity: float32 is the configuration's, bfloat16 the control's.
"""

from __future__ import annotations

import numpy as np
import torch

TH_HIGH = 95
BIG = 10 ** 6
SAD_HALF = 5
SLIDE = 5


def rectify_map(K, D, R, P, width: int, height: int) -> np.ndarray:
    """(H, W, 2) float32 source coordinates (x, y) of each rectified pixel."""
    K = np.asarray(K, np.float64)
    D = np.asarray(D, np.float64).ravel()
    k1, k2, p1, p2 = D[:4]
    k3 = D[4] if D.size > 4 else 0.0
    A = np.asarray(R, np.float64).T @ np.linalg.inv(
        np.asarray(P, np.float64)[:3, :3])
    u, v = np.meshgrid(np.arange(width), np.arange(height))
    rays = np.stack([u, v, np.ones_like(u, np.float64)], -1) @ A.T
    x = rays[..., 0] / rays[..., 2]
    y = rays[..., 1] / rays[..., 2]
    r2 = x * x + y * y
    rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]],
                    -1).astype(np.float32)


def remap(img: torch.Tensor, mp: torch.Tensor, dtype=torch.float32):
    """Bilinear remap with border 0 of an (H, W) image along `mp`."""
    img = img.to(torch.float32).to(dtype)
    H, W = img.shape
    x, y = mp[..., 0], mp[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0).to(dtype), (y - y0).to(dtype)
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)

    def at(yy, xx):
        inb = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        val = img[torch.clamp(yy, 0, H - 1), torch.clamp(xx, 0, W - 1)]
        return torch.where(inb, val, torch.zeros_like(val))

    v00, v01 = at(y0i, x0i), at(y0i, x0i + 1)
    v10, v11 = at(y0i + 1, x0i), at(y0i + 1, x0i + 1)
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def unpack_desc(packed: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1).to(torch.float32)


def hamming_matrix(a_packed, b_packed):
    """(Na, 32) x (Nb, 32) packed descriptors -> (Na, Nb) int32 distances,
    counted bit by bit."""
    a, b = unpack_desc(a_packed), unpack_desc(b_packed)
    return (a[:, None, :] != b[None, :, :]).sum(-1).to(torch.int32)


def masked_best2(dist, mask):
    d = torch.where(mask, dist, torch.full_like(dist, BIG))
    best = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best[:, None])
    rest = d.scatter(1, best[:, None], torch.iinfo(torch.int32).max)
    return best, best_d[:, 0], torch.amin(rest, dim=1)


def _patches(img, cx, cy):
    H, W = img.shape
    off = torch.arange(-SAD_HALF, SAD_HALF + 1, device=img.device)
    yy = torch.clamp(cy[:, None, None] + off[None, :, None], 0, H - 1)
    xx = torch.clamp(cx[:, None, None] + off[None, None, :], 0, W - 1)
    return img.reshape(-1)[yy * W + xx]


def stereo_depth(left, right, img_l, img_r, bf: float,
                 scale_factor: float, min_z: float = 0.1,
                 dtype=torch.float32):
    """Depth (F,) of the left features, -1 where unmatched. `left` and
    `right` are (uv, octave, desc, valid) of the two images' features."""
    uv_l, oct_l, desc_l, valid_l = left
    uv_r, oct_r, desc_r, valid_r = right
    dmat = hamming_matrix(desc_l, desc_r)
    row_tol = 2.0 * scale_factor ** oct_l.to(torch.float32)
    dv = torch.abs(uv_l[:, None, 1] - uv_r[None, :, 1])
    max_d = bf / min_z
    disp = uv_l[:, None, 0] - uv_r[None, :, 0]
    octs = ((oct_r[None, :] >= oct_l[:, None] - 1)
            & (oct_r[None, :] <= oct_l[:, None] + 1))
    mask = ((dv <= row_tol[:, None]) & (disp > 0.1) & (disp < max_d) & octs
            & valid_l[:, None] & valid_r[None, :])
    best, d1, _ = masked_best2(dmat, mask)
    good = d1 <= TH_HIGH
    u_r0 = uv_r[torch.where(good, best, 0), 0]
    il = img_l.to(torch.float32).to(dtype)
    ir = img_r.to(torch.float32).to(dtype)
    c = SAD_HALF
    cxl = torch.round(uv_l[:, 0]).to(torch.int64)
    cyl = torch.round(uv_l[:, 1]).to(torch.int64)
    patch_l = _patches(il, cxl, cyl)
    patch_l = patch_l - patch_l[:, c:c + 1, c:c + 1]
    cxr0 = torch.round(u_r0).to(torch.int64)
    sads = []
    for s in range(-SLIDE, SLIDE + 1):
        patch_r = _patches(ir, cxr0 + s, cyl)
        patch_r = patch_r - patch_r[:, c:c + 1, c:c + 1]
        sads.append(torch.abs(patch_l - patch_r).sum(dim=(1, 2)))
    sad = torch.stack(sads, dim=1)
    best_s = torch.argmin(sad, dim=1)
    interior = (best_s > 0) & (best_s < 2 * SLIDE)
    ctr = torch.clamp(best_s, 1, 2 * SLIDE - 1)
    y0 = torch.gather(sad, 1, (ctr - 1)[:, None])[:, 0]
    y1 = torch.gather(sad, 1, ctr[:, None])[:, 0]
    y2 = torch.gather(sad, 1, (ctr + 1)[:, None])[:, 0]
    delta = 0.5 * (y0 - y2) / torch.clamp(y0 + y2 - 2 * y1, min=1e-6)
    delta_ok = torch.abs(delta) <= 1.0
    u_ref = (cxr0.to(dtype) + (ctr - SLIDE).to(dtype) + delta)
    disparity = cxl.to(dtype) - u_ref
    ok = good & interior & delta_ok & (disparity > 0.01) & (disparity < max_d)
    y1f = y1.to(torch.float32)
    med = torch.nanquantile(torch.where(ok, y1f, torch.full_like(y1f,
                                                                  np.nan)),
                            0.5)
    med = torch.where(torch.isnan(med), torch.full_like(med, np.inf), med)
    ok = ok & (y1f <= 1.5 * 1.4 * med)
    disparity = disparity.to(torch.float32)
    return torch.where(ok, bf / torch.clamp(disparity, min=1e-6),
                       torch.full_like(disparity, -1.0))


def sample_depth(depth_map: torch.Tensor, uv: torch.Tensor, factor: float,
                 edge_rel_tol: float = 0.08, dtype=torch.float32):
    """RGB-D depth at raw keypoint coordinates (nearest pixel), -1 where
    the valid depths of the 3x3 neighbourhood spread by more than
    `edge_rel_tol` of the nearest (a sample across a depth edge)."""
    H, W = depth_map.shape
    x = torch.clamp(torch.round(uv[:, 0]), 0, W - 1).to(torch.int64)
    y = torch.clamp(torch.round(uv[:, 1]), 0, H - 1).to(torch.int64)
    dm = depth_map.to(torch.float32).to(dtype)
    d = dm[y, x] * factor
    offs = torch.tensor([-1, 0, 1], device=uv.device)
    yy = torch.clamp(y[:, None, None] + offs[None, :, None], 0, H - 1)
    xx = torch.clamp(x[:, None, None] + offs[None, None, :], 0, W - 1)
    nb = dm.reshape(-1)[(yy * W + xx).reshape(len(x), 9)] * factor
    inf = torch.full_like(nb, float("inf"))
    ok_nb = nb > 0
    nb_min = torch.amin(torch.where(ok_nb, nb, inf), dim=1)
    nb_max = torch.amax(torch.where(ok_nb, nb, -inf), dim=1)
    flat = (nb_max - nb_min) <= edge_rel_tol * torch.clamp(nb_min, min=1e-6)
    return torch.where((d > 0) & flat, d, torch.full_like(d, -1.0)).to(
        torch.float32)
