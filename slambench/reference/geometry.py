"""Plain geometry of the checks: poses, the motion-only optimum of a
frame's own inlier matches, inlier counts, and the ATE.

Poses are the program's packed world-to-camera [qw qx qy qz tx ty tz]
(`MapState.kf_pose7`, `Frame.pose7`); here they are unpacked and solved in
float64, or, for the control, in bfloat16. The cost is ORB-SLAM2's
PoseOptimization without its robust kernel (its last two rounds): for
every bound feature, (u, v) and, where the feature has a right coordinate
(stereo, RGB-D), u_right = u - bf / z, against the projection of its
landmark, weighted by 1 / sigma^2 of the feature's octave. Nothing here
imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) [w x y z] -> (..., 3, 3), normalized first."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def unpack(pose7: torch.Tensor, dtype=torch.float64):
    p = pose7.to(dtype)
    return quat_to_mat(p[..., :4]), p[..., 4:]


def hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    th = torch.linalg.norm(w, dim=-1, keepdim=True)[..., None]
    K = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    small = th < 1e-12
    ths = torch.where(small, torch.ones_like(th), th)
    A = torch.where(small, torch.ones_like(th), torch.sin(ths) / ths)
    B = torch.where(small, torch.full_like(th, 0.5),
                    (1 - torch.cos(ths)) / (ths * ths))
    return eye + A * K + B * (K @ K)


def residuals(cam, R, t, X, uvr):
    """(N, F, 3) residuals and camera-frame points of landmarks X (N, F, 3)
    against measurements uvr (N, F, 3) at poses R (N, 3, 3), t (N, 3)."""
    fx, fy, cx, cy, bf = cam
    xc = torch.einsum("nij,nfj->nfi", R, X) + t[:, None, :]
    z = torch.clamp(xc[..., 2], min=1e-6)
    u = fx * xc[..., 0] / z + cx
    v = fy * xc[..., 1] / z + cy
    ur = u - bf / z
    stereo = uvr[..., 2] >= 0
    r = torch.stack([u - uvr[..., 0], v - uvr[..., 1],
                     torch.where(stereo, ur - uvr[..., 2],
                                 torch.zeros_like(ur))], -1)
    return r, xc


def solve_poses(cam, pose7, X, uvr, inv_sigma2, mask, dtype=torch.float64,
                iters: int = 15):
    """The least-squares optimum of each frame's pose over its masked
    features, Levenberg-Marquardt from `pose7` (N, 7), in `dtype` (the
    6x6 solve in float32 at least). Returns (R (N, 3, 3), t (N, 3)) in
    float64."""
    R, t = unpack(pose7, dtype)
    X = X.to(dtype)
    uvr = uvr.to(dtype)
    w0 = (inv_sigma2 * mask).to(dtype)
    cam = [torch.as_tensor(c, dtype=dtype, device=X.device) for c in cam]
    fx, fy, _, _, bf = cam
    solve_dt = torch.float64 if dtype == torch.float64 else torch.float32
    lam = torch.full((X.shape[0], 1, 1), 1e-3, dtype=solve_dt,
                     device=X.device)
    eye6 = torch.eye(6, dtype=solve_dt, device=X.device)

    def cost(R, t):
        r, xc = residuals(cam, R, t, X, uvr)
        w = torch.where(xc[..., 2] > 1e-6, w0, torch.zeros_like(w0))
        return (r * r).sum(-1).mul(w).to(solve_dt).sum(-1), r, xc, w

    for _ in range(iters):
        c0, r, xc, w = cost(R, t)
        x, y = xc[..., 0], xc[..., 1]
        z = torch.clamp(xc[..., 2], min=1e-6)
        iz = 1.0 / z
        zero = torch.zeros_like(z)
        du = torch.stack([fx * iz, zero, -fx * x * iz * iz], -1)
        dv = torch.stack([zero, fy * iz, -fy * y * iz * iz], -1)
        dur = du + torch.stack([zero, zero, bf * iz * iz], -1)
        stereo = (uvr[..., 2] >= 0)[..., None]
        dr = torch.stack([du, dv, torch.where(stereo, dur,
                                              torch.zeros_like(dur))], -2)
        eye3 = torch.eye(3, dtype=dtype, device=X.device).expand(
            xc.shape[:-1] + (3, 3))
        J = dr @ torch.cat([-hat(xc), eye3], -1)          # (N, F, 3, 6)
        Js = J.to(solve_dt)
        ws = w.to(solve_dt)
        H = torch.einsum("nfij,nf,nfik->njk", Js, ws, Js)
        g = torch.einsum("nfij,nf,nfi->nj", Js, ws, r.to(solve_dt))
        Hd = H + lam * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1))
        dx = torch.linalg.solve(Hd + 1e-12 * eye6, -g[..., None])[..., 0]
        dx = dx.to(dtype)
        dR = so3_exp(dx[..., :3])
        Rn = dR @ R
        tn = torch.einsum("nij,nj->ni", dR, t) + dx[..., 3:]
        c1 = cost(Rn, tn)[0]
        acc = (c1 < c0)
        R = torch.where(acc[:, None, None], Rn, R)
        t = torch.where(acc[:, None], tn, t)
        lam = torch.where(acc[:, None, None], lam * 0.3, lam * 10.0)
    return R.to(torch.float64), t.to(torch.float64)


def pose_gap_mm(R1, t1, R2, t2, X, mask) -> torch.Tensor:
    """(N,) largest distance, in mm, by which one of a frame's masked
    landmarks lies apart in the two camera frames."""
    X = X.to(torch.float64)
    a = torch.einsum("nij,nfj->nfi", R1, X) + t1[:, None]
    b = torch.einsum("nij,nfj->nfi", R2, X) + t2[:, None]
    d = torch.linalg.norm(a - b, dim=-1) * 1e3
    return torch.where(mask, d, torch.zeros_like(d)).amax(-1)


def inlier_count(cam, R, t, X, uvr, inv_sigma2, mask) -> torch.Tensor:
    """(N,) features of `mask` whose chi-square at (R, t) is within
    ORB-SLAM2's inlier threshold (5.991 mono, 7.815 with a right
    coordinate)."""
    cam = [torch.as_tensor(c, dtype=torch.float64, device=X.device)
           for c in cam]
    r, xc = residuals(cam, R, t, X.to(torch.float64),
                      uvr.to(torch.float64))
    chi2 = (r * r).sum(-1) * inv_sigma2.to(torch.float64)
    th = torch.where(uvr[..., 2] >= 0, CHI2_STEREO, CHI2_MONO)
    return (mask & (chi2 <= th) & (xc[..., 2] > 1e-6)).sum(-1)


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """RMSE of the SE3-aligned (Umeyama, no scale) estimated camera centres
    `est` (N, 3) against the true ones `gt` (N, 3), in the units given."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, _, Vt = np.linalg.svd(G.T @ E / len(est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    Rg = U @ S @ Vt
    aligned = (Rg @ E.T).T + mu_g
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))
