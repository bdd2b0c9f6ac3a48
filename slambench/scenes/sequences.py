"""Camera models, periodic trajectories and the rendered sequences a cell
runs on.

A traffic mix (`slambench/traffic/<mix>.json`) gives the room (its
`layout_seed` and `texture_seed`) and a trajectory as a sum of harmonics
over one period of `period_frames` frames, so the sequence wraps without
a jump. Every seed runs the same motion through the same room; the seed
draws the sensor noise of every image (Gaussian, `noise_grey_sigma` grey
levels, on the card), so each seed gives other images of the same work.
A configuration (`slambench/configs/<config>.json`) gives the camera: a
distorted pinhole (TUM1), or a raw distorted stereo rig with its
rectification (EuRoC), each rendered along its own per-pixel rays, so that
undistortion and rectification do their real work.
"""

from __future__ import annotations

import numpy as np
import torch

from .render import Room, room_planes

AXES = ("x", "y", "z", "rx", "ry", "rz")


def so3_exp(w) -> np.ndarray:
    """Rotation matrix of the rotation vector `w` (Rodrigues, float64)."""
    w = np.asarray(w, np.float64)
    th = float(np.linalg.norm(w))
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def harmonic_poses(motion: dict, n_frames: int, first: int = 0):
    """World-to-camera poses [(R, t)] and camera centres (n, 3) of frames
    first .. first + n_frames - 1 of a periodic motion: the centre and the
    rotation vector (camera-to-world) are `base` plus a sum of terms
    amp * sin(2 pi k f / period + phase) per axis."""
    period = motion["period_frames"]
    base = np.asarray(motion["base"], np.float64)
    poses, centres = [], []
    for f in range(first, first + n_frames):
        v = base.copy()
        for term in motion["terms"]:
            v[AXES.index(term["axis"])] += term["amp"] * np.sin(
                2 * np.pi * term["k"] * (f % period) / period
                + term.get("phase", 0.0))
        c, rot = v[:3], v[3:]
        R = so3_exp(rot).T
        poses.append((R, -R @ c))
        centres.append(c)
    return poses, np.stack(centres)


def distort(x, y, D):
    """Brown-Conrady distortion of normalized coordinates (k1 k2 p1 p2 k3)."""
    k1, k2, p1, p2, k3 = D
    r2 = x * x + y * y
    rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    return (x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x),
            y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)


def raw_dirs(width: int, height: int, K, D) -> np.ndarray:
    """(H, W, 3) float64 rays (x, y, 1) of a distorted camera's pixels:
    each pixel's normalized coordinate undistorted by fixed-point
    iteration until it moves by less than 1e-13."""
    K = np.asarray(K, np.float64).reshape(3, 3)
    D = list(np.asarray(D, np.float64).ravel()) + [0.0] * 5
    D = D[:5]
    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    xd = (u - K[0, 2]) / K[0, 0]
    yd = (v - K[1, 2]) / K[1, 1]
    x, y = xd.copy(), yd.copy()
    for _ in range(500):
        dx, dy = distort(x, y, D)
        xn, yn = x + (xd - dx), y + (yd - dy)
        moved = max(np.abs(xn - x).max(), np.abs(yn - y).max())
        x, y = xn, yn
        if moved < 1e-13:
            break
    return np.stack([x, y, np.ones_like(x)], -1)


class Sequence:
    """One period of a cell's frames, rendered on `device` and held on the
    host as decoded files would be. Frame f of the run is frame
    f % period of the period."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config = config
        self.mix = mix
        self.seed = seed
        motion = mix["motion"]
        self.period = motion["period_frames"]
        self.rng = np.random.RandomState(seed % 2 ** 32)
        self.fps = float(config["settings"]["Camera.fps"])
        self.room = Room(room_planes(mix["texture_seed"], mix["layout_seed"]),
                         device)
        self.poses, self.centres = harmonic_poses(motion, self.period)
        self.device = torch.device(device)
        self.noise = torch.Generator(device=self.device)
        self.noise.manual_seed(seed % 2 ** 63)
        self.sigma = float(mix["noise_grey_sigma"])
        if config["sensor"] == "rgbd":
            self._render_rgbd()
        else:
            self._render_stereo()

    def index(self, f: int) -> int:
        return f % self.period

    def pose(self, f: int):
        """True world-to-camera (R, t) of the run's frame f (the rectified
        left camera of a stereo rig)."""
        return self.poses[self.index(f)]

    def timestamp(self, f: int) -> float:
        return f / self.fps

    def _render_rgbd(self):
        s = self.config["settings"]
        K = [[s["Camera.fx"], 0, s["Camera.cx"]],
             [0, s["Camera.fy"], s["Camera.cy"]], [0, 0, 1]]
        D = [s["Camera.k1"], s["Camera.k2"], s["Camera.p1"], s["Camera.p2"],
             s.get("Camera.k3", 0.0)]
        dirs = torch.as_tensor(raw_dirs(s["Camera.width"],
                                        s["Camera.height"], K, D),
                               device=self.device)
        factor = float(s["DepthMapFactor"])
        imgs, depths = [], []
        for R, t in self.poses:
            img, z = self.room.render(R, t, dirs)
            imgs.append(img)
            # a 16-bit depth map at DepthMapFactor counts per metre, handed
            # over as the float32 raw values a decoded TUM depth file gives
            depths.append(torch.clamp(z * factor, 0, 65535).to(torch.int32))
        self.images = self._noisy(torch.stack(imgs)).cpu().numpy()
        self.depths = torch.stack(depths).cpu().numpy().astype(np.float32)

    def rig(self):
        """(K_l, D_l, R_l, P_l, K_r, D_r, R_r, P_r) as float64 arrays."""
        s = self.config["settings"]

        def m(key, shape):
            return np.asarray(s[key], np.float64).reshape(shape)
        return (m("LEFT.K", (3, 3)), m("LEFT.D", (-1,)), m("LEFT.R", (3, 3)),
                m("LEFT.P", (3, 4)), m("RIGHT.K", (3, 3)),
                m("RIGHT.D", (-1,)), m("RIGHT.R", (3, 3)),
                m("RIGHT.P", (3, 4)))

    def _render_stereo(self):
        s = self.config["settings"]
        K_l, D_l, R_l, P_l, K_r, D_r, R_r, P_r = self.rig()
        w, h = s["LEFT.width"], s["LEFT.height"]
        dirs_l = torch.as_tensor(raw_dirs(w, h, K_l, D_l), device=self.device)
        dirs_r = torch.as_tensor(raw_dirs(w, h, K_r, D_r), device=self.device)
        baseline = -P_r[0, 3] / P_r[0, 0]
        lefts, rights = [], []
        for R, t in self.poses:
            # the raw cameras: X_raw = R_rect^T X_rect; the right rectified
            # camera sits `baseline` along the left one's x axis
            lefts.append(self.room.render(R_l.T @ R, R_l.T @ t, dirs_l)[0])
            rights.append(self.room.render(
                R_r.T @ R, R_r.T @ (t - np.array([baseline, 0.0, 0.0])),
                dirs_r)[0])
        self.images = self._noisy(torch.stack(lefts)).cpu().numpy()
        self.rights = self._noisy(torch.stack(rights)).cpu().numpy()

    def _noisy(self, imgs: torch.Tensor) -> torch.Tensor:
        """uint8 images with the seed's sensor noise added (the card's
        generator, 16 images a draw), rounded and clipped."""
        out = torch.empty_like(imgs)
        for i in range(0, imgs.shape[0], 16):
            chunk = imgs[i:i + 16]
            noise = torch.randn(chunk.shape, generator=self.noise,
                                device=self.device) * self.sigma
            out[i:i + 16] = torch.clamp(torch.round(chunk.float() + noise),
                                        0, 255).to(torch.uint8)
        return out
