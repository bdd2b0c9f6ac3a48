"""Synthetic scenes with exact ground truth, numpy only.

Port of `orb_slam2_e_tpu/utils/synthetic.py` (`SyntheticScene` and
`orbit_trajectory`): textured squares rendered along a known trajectory,
with a matching depth map for RGB-D. The reference builds the orbit's yaw
with its JAX `lie.so3_exp`; here it is Rodrigues' formula in float32 numpy.
"""

from __future__ import annotations

import numpy as np


def so3_exp_np(w) -> np.ndarray:
    """Rodrigues' formula for one axis-angle vector, float32."""
    w = np.asarray(w, dtype=np.float32)
    theta2 = np.float32(np.dot(w, w))
    W = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                  [-w[1], w[0], 0.0]], dtype=np.float32)
    if theta2 < 1e-10:
        a = np.float32(1.0 - theta2 / 6.0)
        b = np.float32(0.5 - theta2 / 24.0)
    else:
        theta = np.sqrt(theta2)
        a = np.sin(theta) / theta
        b = (np.float32(1.0) - np.cos(theta)) / theta2
    return (np.eye(3, dtype=np.float32) + a * W + b * (W @ W)).astype(
        np.float32)


class SyntheticScene:
    """World = N textured squares (3D position + intensity + size),
    rendered with painter's order by depth on a supersampled grid."""

    def __init__(self, n_points=400, seed=0, extent=(6.0, 4.0),
                 depth=(4.0, 9.0), width=640, height=480, fx=500.0,
                 fy=500.0, cx=320.0, cy=240.0, supersample=4):
        rng = np.random.RandomState(seed)
        ex, ey = extent
        self.xyz = np.stack([
            rng.uniform(-ex, ex, n_points),
            rng.uniform(-ey, ey, n_points),
            rng.uniform(depth[0], depth[1], n_points)], 1).astype(np.float32)
        self.intensity = rng.uniform(60, 255, n_points).astype(np.float32)
        self.size = rng.uniform(0.08, 0.18, n_points).astype(np.float32)
        self.pattern = rng.uniform(25, 235, (n_points, 3, 3)).astype(
            np.float32)
        self.W, self.H = width, height
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.ss = int(supersample)

    def render(self, R: np.ndarray, t: np.ndarray) -> np.ndarray:
        """Render from camera pose Tcw = (R, t). Returns (H, W) float32."""
        S = self.ss
        Ws, Hs = self.W * S, self.H * S
        img = np.full((Hs, Ws), 20.0, np.float32)
        xc = (R @ self.xyz.T).T + t
        z = xc[:, 2]
        for i in np.argsort(-z):               # far first
            if z[i] <= 0.3:
                continue
            u = (self.fx * xc[i, 0] / z[i] + self.cx + 0.5) * S - 0.5
            v = (self.fy * xc[i, 1] / z[i] + self.cy + 0.5) * S - 0.5
            half = max(2 * S, int(round(self.fx * self.size[i] / z[i] / 2
                                        * S)))
            x0, x1 = int(round(u)) - half, int(round(u)) + half
            y0, y1 = int(round(v)) - half, int(round(v)) + half
            if x1 < 0 or y1 < 0 or x0 >= Ws or y0 >= Hs:
                continue
            xe = np.round(np.linspace(x0, x1, 4)).astype(int)
            ye = np.round(np.linspace(y0, y1, 4)).astype(int)
            for a in range(3):
                for b in range(3):
                    xs0, xs1 = max(xe[b], 0), min(xe[b + 1], Ws)
                    ys0, ys1 = max(ye[a], 0), min(ye[a + 1], Hs)
                    if xs1 > xs0 and ys1 > ys0:
                        img[ys0:ys1, xs0:xs1] = self.pattern[i, a, b]
        if S == 1:
            return img
        return img.reshape(self.H, S, self.W, S).mean(axis=(1, 3))

    def depth_map(self, R: np.ndarray, t: np.ndarray) -> np.ndarray:
        """Ground-truth depth rendered the same way (RGB-D)."""
        dm = np.zeros((self.H, self.W), np.float32)
        xc = (R @ self.xyz.T).T + t
        z = xc[:, 2]
        for i in np.argsort(-z):
            if z[i] <= 0.3:
                continue
            u = self.fx * xc[i, 0] / z[i] + self.cx
            v = self.fy * xc[i, 1] / z[i] + self.cy
            half = max(2, int(round(self.fx * self.size[i] / z[i] / 2)))
            x0 = max(int(round(u)) - half, 0)
            x1 = min(int(round(u)) + half, self.W)
            y0 = max(int(round(v)) - half, 0)
            y1 = min(int(round(v)) + half, self.H)
            if x1 <= x0 or y1 <= y0:
                continue
            dm[y0:y1, x0:x1] = z[i]
        return dm


def orbit_trajectory(n_frames=30, radius=0.8, forward=0.02):
    """Smooth sideways + forward sweep: ([(R, t)] Tcw poses, (N, 3) camera
    centers)."""
    poses = []
    centers = []
    for k in range(n_frames):
        c = np.array([radius * k / n_frames, 0.02 * np.sin(k / 5.0),
                      forward * k], np.float32)
        yaw = -0.3 * (c[0] / max(radius, 1e-6)) * 0.2
        Rwc = so3_exp_np([0.0, yaw, 0.0])
        R = Rwc.T
        t = -R @ c
        poses.append((R.astype(np.float32), t.astype(np.float32)))
        centers.append(c)
    return poses, np.stack(centers)
