"""Stereo rectification of raw stereo pairs (EuRoC style).

Port of `orb_slam2_e_tpu/utils/rectify.py` (reference
Examples/Stereo/stereo_euroc.cc: cv::initUndistortRectifyMap + cv::remap).
The map is built once on the host in numpy; the per-frame remap is a
bilinear gather on the image's device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import trace


def rectify_map(K: np.ndarray, D: np.ndarray, R: np.ndarray, P: np.ndarray,
                width: int, height: int) -> np.ndarray:
    """(H, W, 2) float32 map of source pixel coords (x, y) for each
    rectified pixel, as OpenCV's initUndistortRectifyMap (pinhole + radtan).

    K/D: original intrinsics and distortion (k1 k2 p1 p2 [k3]); R: the
    rectifying rotation; P: the new 3x4 (or 3x3) projection."""
    K = np.asarray(K, np.float64)
    D = np.asarray(D, np.float64).ravel()
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    k3 = D[4] if D.size > 4 else 0.0
    R = np.asarray(R, np.float64)
    P = np.asarray(P, np.float64)
    A = R.T @ np.linalg.inv(P[:3, :3])     # rectified pixel -> source ray
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


def remap_bilinear(img: torch.Tensor, mp: torch.Tensor) -> torch.Tensor:
    """cv::remap(INTER_LINEAR, BORDER_CONSTANT=0): img (H, W) float32,
    mp (H, W, 2) source (x, y) -> rectified (H, W) float32."""
    H, W = img.shape
    x, y = mp[..., 0], mp[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)

    def at(yy, xx):
        inb = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        val = img[torch.clamp(yy, 0, H - 1), torch.clamp(xx, 0, W - 1)]
        return torch.where(inb, val, torch.zeros_like(val))

    v00, v01 = at(y0i, x0i), at(y0i, x0i + 1)
    v10, v11 = at(y0i + 1, x0i), at(y0i + 1, x0i + 1)
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


class StereoRectifier:
    """Precomputed left/right rectification of a raw stereo rig; the maps
    live on `device`."""

    def __init__(self, K_l, D_l, R_l, P_l, K_r, D_r, R_r, P_r,
                 width: int, height: int, *, device):
        self.device = torch.device(device)
        self.map_l = torch.from_numpy(rectify_map(
            K_l, D_l, R_l, P_l, width, height)).to(self.device)
        self.map_r = torch.from_numpy(rectify_map(
            K_r, D_r, R_r, P_r, width, height)).to(self.device)

    def __call__(self, img_left, img_right):
        def f32(im):
            return torch.as_tensor(im, device=self.device).to(torch.float32)
        with trace.span("rectify"):
            return (remap_bilinear(f32(img_left), self.map_l),
                    remap_bilinear(f32(img_right), self.map_r))
