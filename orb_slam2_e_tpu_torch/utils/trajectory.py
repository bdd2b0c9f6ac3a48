"""Trajectory export/import in TUM and KITTI formats and ATE/RPE
evaluation, numpy only.

Port of `orb_slam2_e_tpu/utils/trajectory.py`: the TUM and KITTI writers
(reference System::SaveTrajectoryTUM / SaveTrajectoryKITTI), the TUM
reader, and ATE / RPE RMSE after Umeyama alignment.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def quat_from_mat(R: np.ndarray) -> np.ndarray:
    """(N, 3, 3) rotations -> (N, 4) unit quaternions (w, x, y, z), the
    branch-free Shepperd construction of ops/lie.py in numpy."""
    R = np.asarray(R, dtype=np.float64)
    m00, m01, m02 = R[:, 0, 0], R[:, 0, 1], R[:, 0, 2]
    m10, m11, m12 = R[:, 1, 0], R[:, 1, 1], R[:, 1, 2]
    m20, m21, m22 = R[:, 2, 0], R[:, 2, 1], R[:, 2, 2]
    tr = m00 + m11 + m22
    piv = np.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                    -m00 - m11 + m22], axis=-1)
    s = np.sqrt(np.maximum(1.0 + piv, 0.0)) * 0.5        # qw qx qy qz pivots
    d = np.maximum(4 * s, 1e-8)
    cands = np.stack([
        np.stack([s[:, 0], (m21 - m12) / d[:, 0], (m02 - m20) / d[:, 0],
                  (m10 - m01) / d[:, 0]], -1),
        np.stack([(m21 - m12) / d[:, 1], s[:, 1], (m01 + m10) / d[:, 1],
                  (m02 + m20) / d[:, 1]], -1),
        np.stack([(m02 - m20) / d[:, 2], (m01 + m10) / d[:, 2], s[:, 2],
                  (m12 + m21) / d[:, 2]], -1),
        np.stack([(m10 - m01) / d[:, 3], (m02 + m20) / d[:, 3],
                  (m12 + m21) / d[:, 3], s[:, 3]], -1)], axis=1)
    q = cands[np.arange(len(R)), np.argmax(piv, axis=-1)]
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-8)
    return np.where(q[:, :1] < 0, -q, q)


def save_tum(path, timestamps, R_wc, t_wc):
    """Write `time tx ty tz qx qy qz qw` per row (camera-to-world)."""
    q = quat_from_mat(R_wc)
    t = np.asarray(t_wc)
    with open(path, 'w') as f:
        for i, ts in enumerate(timestamps):
            f.write(f"{ts:.6f} {t[i,0]:.7f} {t[i,1]:.7f} {t[i,2]:.7f} "
                    f"{q[i,1]:.7f} {q[i,2]:.7f} {q[i,3]:.7f} {q[i,0]:.7f}\n")


def save_kitti(path, R_wc, t_wc):
    """Write a 3x4 [R|t] row-major camera-to-world matrix per line."""
    R = np.asarray(R_wc)
    t = np.asarray(t_wc)
    with open(path, 'w') as f:
        for i in range(len(R)):
            P = np.hstack([R[i], t[i][:, None]]).reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in P) + "\n")


def load_tum(path):
    """-> (timestamps (N,), t_wc (N, 3), q_wxyz (N, 4))."""
    rows = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith('#'):
            continue
        rows.append([float(x) for x in line.split()][:8])
    a = np.asarray(rows)
    q = np.stack([a[:, 7], a[:, 4], a[:, 5], a[:, 6]], axis=1)  # -> wxyz
    return a[:, 0], a[:, 1:4], q


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Least-squares similarity y ~ s R x + t over (N, 3) point sets."""
    mu_x = x.mean(axis=0)
    mu_y = y.mean(axis=0)
    xc, yc = x - mu_x, y - mu_y
    cov = yc.T @ xc / len(x)
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_x = (xc ** 2).sum() / len(x)
    s = float(np.trace(np.diag(d) @ S) / var_x) if with_scale else 1.0
    t = mu_y - s * R @ mu_x
    return s, R, t


def ate_rmse(est_t: np.ndarray, gt_t: np.ndarray,
             with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after Umeyama alignment (meters)."""
    s, R, t = umeyama_alignment(est_t, gt_t, with_scale)
    aligned = (s * (R @ est_t.T)).T + t
    return float(np.sqrt(((aligned - gt_t) ** 2).sum(axis=1).mean()))


def rpe_rmse(R_est, t_est, R_gt, t_gt, delta: int = 1):
    """Relative pose error RMSE (translation, metres) over frame pairs."""
    errs = []
    for i in range(len(t_est) - delta):
        dt_e = R_est[i].T @ (t_est[i + delta] - t_est[i])
        dR_g = R_gt[i].T @ R_gt[i + delta]
        dt_g = R_gt[i].T @ (t_gt[i + delta] - t_gt[i])
        e_t = dR_g.T @ (dt_e - dt_g)
        errs.append(e_t @ e_t)
    return float(np.sqrt(np.mean(errs))) if errs else 0.0
