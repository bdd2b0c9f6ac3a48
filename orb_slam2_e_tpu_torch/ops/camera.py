"""Pinhole camera with Brown-Conrady distortion.

Port of `orb_slam2_e_tpu/ops/camera.py`. Every calibration field is a 0-d
float32 tensor, as the reference's Camera holds f32 arrays: arithmetic such
as `bf / fx * th_depth` then rounds in float32 in both packages.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Camera(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    k3: torch.Tensor
    bf: torch.Tensor      # stereo baseline * fx (0 for monocular)
    width: torch.Tensor   # image width in px (float)
    height: torch.Tensor  # image height in px (float)

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
               bf=0.0, width=640, height=480, dtype=torch.float32,
               device="cpu"):
        def a(v):
            return torch.as_tensor(v, dtype=dtype, device=device)
        return Camera(a(fx), a(fy), a(cx), a(cy), a(k1), a(k2), a(p1), a(p2),
                      a(k3), a(bf), a(width), a(height))

    def to(self, device) -> "Camera":
        return Camera(*(v.to(device) for v in self))

    @property
    def K(self):
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack([
            torch.stack([self.fx, z, self.cx], -1),
            torch.stack([z, self.fy, self.cy], -1),
            torch.stack([z, z, o], -1)], -2)

    @property
    def baseline(self):
        return self.bf / self.fx


def distort_normalized(cam: Camera, xn: torch.Tensor) -> torch.Tensor:
    """Apply Brown-Conrady distortion to normalized coords (..., 2)."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(cam: Camera, xd: torch.Tensor,
                         iters: int = 8) -> torch.Tensor:
    """Invert distortion by fixed-point iteration (cv::undistortPoints'
    scheme with a static iteration count)."""
    x = xd
    for _ in range(iters):
        xx, yy = x[..., 0], x[..., 1]
        r2 = xx * xx + yy * yy
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        dx = 2.0 * cam.p1 * xx * yy + cam.p2 * (r2 + 2.0 * xx * xx)
        dy = cam.p1 * (r2 + 2.0 * yy * yy) + 2.0 * cam.p2 * xx * yy
        x = torch.stack([(xd[..., 0] - dx) / radial,
                         (xd[..., 1] - dy) / radial], dim=-1)
    return x


def pixel_to_normalized(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    return torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                        (uv[..., 1] - cam.cy) / cam.fy], dim=-1)


def normalized_to_pixel(cam: Camera, xn: torch.Tensor) -> torch.Tensor:
    return torch.stack([xn[..., 0] * cam.fx + cam.cx,
                        xn[..., 1] * cam.fy + cam.cy], dim=-1)


def undistort_pixels(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Distorted pixel coords -> ideal (undistorted) pixel coords."""
    return normalized_to_pixel(
        cam, undistort_normalized(cam, pixel_to_normalized(cam, uv)))


def _safe_depth(z: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def project(cam: Camera, xc: torch.Tensor, distort: bool = False):
    """Camera-frame points (..., 3) -> pixel (..., 2), depth. Tracking works
    on undistorted keypoints, hence the default; `distort=True` is the
    viewer's overlay projection (reference FrameDrawer DistortMapPoint)."""
    z = xc[..., 2]
    xn = xc[..., :2] / _safe_depth(z)[..., None]
    if distort:
        xn = distort_normalized(cam, xn)
    return normalized_to_pixel(cam, xn), z


def project_stereo(cam: Camera, xc: torch.Tensor):
    """-> (u, v, ur) (..., 3) and depth, ur = u - bf / z (reference
    Frame.cc:704-725)."""
    uv, z = project(cam, xc)
    ur = uv[..., 0] - cam.bf / _safe_depth(z)
    return torch.cat([uv, ur[..., None]], dim=-1), z


def backproject(cam: Camera, uv: torch.Tensor, z: torch.Tensor):
    """Undistorted pixel + depth -> camera-frame 3D point."""
    x = (uv[..., 0] - cam.cx) / cam.fx * z
    y = (uv[..., 1] - cam.cy) / cam.fy * z
    return torch.stack([x, y, z], dim=-1)


def in_image(cam: Camera, uv: torch.Tensor, margin: float = 0.0):
    return ((uv[..., 0] >= margin) & (uv[..., 0] < cam.width - margin)
            & (uv[..., 1] >= margin) & (uv[..., 1] < cam.height - margin))
