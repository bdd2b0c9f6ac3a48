"""Synthetic scenes with exact ground truth, as numpy arrays.

Port of `orb_slam2_e_tpu/utils/synthetic.py`: textured squares rendered
along a known trajectory, with a matching depth map for RGB-D; the orbit
and, for loop closure, a ring scene with a circle trajectory that revisits
its start. The reference builds the orbit's yaw with its JAX `lie.so3_exp`;
here it is Rodrigues' formula in float32 numpy.

For the deformable mode, `deformed_grid_map` is the scene of the
reference's own tests of it (tests/test_deformable.py,
tests/test_reloc_kpi.py) as numpy arrays: a two-keyframe map of a grid
surface at rest and a query frame that sees the surface deformed.
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


def make_ring_scene(n_points=600, seed=0, ring_radius=9.0, band_height=2.5,
                    **kwargs) -> SyntheticScene:
    """Scene whose points lie on a cylindrical band around the origin, for
    `circle_trajectory`: the camera travels a circle looking outward and
    sees its start again. `band_height` is the band's half-height; `height`
    passes through to SyntheticScene as the image height."""
    rng = np.random.RandomState(seed)
    scene = SyntheticScene(n_points=n_points, seed=seed, **kwargs)
    # keep the squares' apparent size near the default scene's at the
    # ring's viewing distance, or their 3x3 texture aliases away
    scene.size = scene.size * max(1.0, (ring_radius - 2.0) / 6.0)
    theta = rng.uniform(0, 2 * np.pi, n_points)
    r = ring_radius + rng.uniform(-1.0, 1.0, n_points)
    y = rng.uniform(-band_height, band_height, n_points)
    scene.xyz = np.stack([r * np.sin(theta), y, r * np.cos(theta)],
                         1).astype(np.float32)
    return scene


def circle_trajectory(n_frames=64, radius=2.0, frac=1.1, seed=0,
                      jitter=0.0):
    """Camera centers on a circle of `radius` in the x-z plane, the optical
    axis pointing radially outward; `frac` > 1 closes the loop and keeps
    going, so the revisit lasts several keyframes. `jitter` turns each
    camera by a random rotation of that many radians (standard deviation
    per axis), drawn from `seed`. Returns ([(R, t)] Tcw poses, (N, 3)
    camera centers)."""
    rng = np.random.RandomState(seed)
    poses, centers = [], []
    for k in range(n_frames):
        th = 2 * np.pi * frac * k / n_frames
        c = np.array([radius * np.sin(th), 0.0, radius * np.cos(th)],
                     np.float32)
        # camera axes in world coordinates: z outward, x tangent, y world y
        zax = np.array([np.sin(th), 0.0, np.cos(th)], np.float32)
        xax = np.array([np.cos(th), 0.0, -np.sin(th)], np.float32)
        yax = np.array([0.0, 1.0, 0.0], np.float32)
        Rwc = np.stack([xax, yax, zax], 1)
        if jitter:
            Rwc = Rwc @ so3_exp_np(rng.randn(3).astype(np.float32) * jitter)
        R = Rwc.T
        t = -R @ c
        poses.append((R.astype(np.float32), t.astype(np.float32)))
        centers.append(c)
    return poses, np.stack(centers)


def orbit_trajectory(n_frames=30, radius=0.8, forward=0.02, seed=0,
                     jitter=0.0):
    """Smooth sideways + forward sweep: ([(R, t)] Tcw poses, (N, 3) camera
    centers). `jitter` turns each camera by a random rotation of that many
    radians (standard deviation per axis), drawn from `seed`."""
    rng = np.random.RandomState(seed)
    poses = []
    centers = []
    for k in range(n_frames):
        c = np.array([radius * k / n_frames, 0.02 * np.sin(k / 5.0),
                      forward * k], np.float32)
        yaw = -0.3 * (c[0] / max(radius, 1e-6)) * 0.2
        Rwc = so3_exp_np([0.0, yaw, 0.0])
        if jitter:
            Rwc = Rwc @ so3_exp_np(rng.randn(3).astype(np.float32) * jitter)
        R = Rwc.T
        t = -R @ c
        poses.append((R.astype(np.float32), t.astype(np.float32)))
        centers.append(c)
    return poses, np.stack(centers)


def quat_from_rotation_np(R) -> np.ndarray:
    """Unit quaternion (w, x, y, z) of a rotation near the identity
    (trace > 0), float32."""
    R = np.asarray(R, np.float64)
    w = 0.5 * np.sqrt(1.0 + np.trace(R))
    return np.array([w, (R[2, 1] - R[1, 2]) / (4 * w),
                     (R[0, 2] - R[2, 0]) / (4 * w),
                     (R[1, 0] - R[0, 1]) / (4 * w)], np.float32)


def deformed_grid_map(n_grid=13, defmag=0.45, tang=0.34, seed=3, noise=0.3,
                      max_keyframes=8, max_features=256, max_points=512,
                      fx=400.0, cx=240.0, cy=180.0, tang_wave=(2.1, 1.9),
                      max_dist=20.0):
    """A map of an n_grid x n_grid surface at rest (z = 5, 3.0 x 2.4 m) seen
    by two keyframes, and a query frame that sees the DEFORMED surface from
    another pose. Every landmark has a random descriptor of its own, which
    the keyframes and the frame observe exactly.

    The deformation is smooth and multi-modal, `defmag` along z and
    `tang * defmag` in the plane (waves of `tang_wave` rad/m), so that no
    rigid motion absorbs it.
    `max_dist` is the landmarks' scale-invariance distance: the projection
    search predicts a landmark at distance d at pyramid level
    ceil(log(max_dist / d) / log(scale_factor)), clamped to the pyramid, and
    accepts features within one level of that. Every feature here is of
    level 0, so in a pyramid of more than two levels the searches leave out
    the landmarks nearer than max_dist / scale_factor (the surface lies
    about 5 m from the frame); with two levels the clamp hides that.

    Returns numpy arrays: {"map": MapState fields (capacities as given),
    "frame": Frame fields (unbound, identity pose), "pose7_true": the
    frame's pose, "pts", "pts_def", "desc", "n"}. Binding the frame to the
    map by hand is `dict(frame, pose7=pose7_true, point_ids=...)` with ids
    0..n-1 on its first n rows."""
    rng = np.random.RandomState(seed)
    K, F, P = max_keyframes, max_features, max_points
    n = n_grid * n_grid
    if n > F or n > P:
        raise ValueError(f"{n} grid points exceed the capacities {F}, {P}")
    xs, ys = np.meshgrid(np.linspace(-1.5, 1.5, n_grid),
                         np.linspace(-1.2, 1.2, n_grid))
    pts = np.stack([xs.ravel(), ys.ravel(), np.full(n, 5.0)], 1).astype(
        np.float32)
    pts_def = pts + np.stack([
        tang * defmag * np.sin(tang_wave[0] * pts[:, 1] + 1),
        tang * defmag * np.cos(tang_wave[1] * pts[:, 0] - 0.5),
        defmag * np.sin(2.3 * pts[:, 0]) * np.cos(1.7 * pts[:, 1])],
        1).astype(np.float32)
    desc = rng.randint(0, 256, (n, 32), dtype=np.uint8)

    def project(R, t, X):
        xc = (R @ X.T).T + t
        return np.stack([fx * xc[:, 0] / xc[:, 2] + cx,
                         fx * xc[:, 1] / xc[:, 2] + cy], 1)

    def pose7(R, t):
        return np.concatenate([quat_from_rotation_np(R),
                               np.asarray(t, np.float32)])

    def rows(vals, fill, dtype):
        out = np.full((F,) + np.shape(vals)[1:], fill, dtype)
        out[:n] = vals
        return out

    from ..models.map_state import MapState
    m = {k: v.numpy() for k, v in MapState.create(
        K, F, P, device="cpu")._asdict().items()}
    m["next_seq"] = np.int32(2)
    m["lm_xyz"][:n] = pts
    m["lm_valid"][:n] = True
    m["lm_desc"][:n] = desc
    m["lm_max_dist"][:n] = max_dist
    m["lm_min_dist"][:n] = 0.1
    kf_poses = [(np.eye(3, dtype=np.float32), np.zeros(3, np.float32)),
                (so3_exp_np([0.0, 0.1, 0.0]),
                 np.array([-0.3, 0, 0], np.float32))]
    for s, (R, t) in enumerate(kf_poses):
        m["kf_pose7"][s] = pose7(R, t)
        m["kf_valid"][s] = True
        m["kf_frame_id"][s] = s
        m["kf_seq"][s] = s
        m["kf_kp_uvr"][s] = rows(np.concatenate(
            [project(R, t, pts), np.full((n, 1), -1.0)], 1), -1.0, np.float32)
        m["kf_kp_valid"][s, :n] = True
        m["kf_desc"][s, :n] = desc
        m["kf_kp_point"][s, :n] = np.arange(n)

    R_f = so3_exp_np([0.02, -0.05, 0.01])
    t_f = np.array([0.1, 0.05, -0.1], np.float32)
    uv_f = project(R_f, t_f, pts_def) + rng.randn(n, 2) * noise
    uvr = rows(np.concatenate([uv_f, np.full((n, 1), -1.0)], 1), -1.0,
               np.float32)
    valid = np.zeros(F, bool)
    valid[:n] = True
    frame = {
        "pose7": np.array([1, 0, 0, 0, 0, 0, 0], np.float32), "uvr": uvr,
        "uv_raw": uvr[:, :2].copy(),
        "octave": np.zeros(F, np.int32), "angle": np.zeros(F, np.float32),
        "response": np.zeros(F, np.float32), "desc": rows(desc, 0, np.uint8),
        "valid": valid, "point_ids": np.full(F, -1, np.int32),
        "depth": np.full(F, -1.0, np.float32),
    }
    return {"map": m, "frame": frame, "pose7_true": pose7(R_f, t_f),
            "pts": pts, "pts_def": pts_def, "desc": desc, "n": n}
