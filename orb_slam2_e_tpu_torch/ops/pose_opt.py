"""Motion-only bundle adjustment: Levenberg-Marquardt on one SE(3) pose.

Port of `orb_slam2_e_tpu/ops/pose_opt.py` (reference
Optimizer::PoseOptimization): unary reprojection edges from fixed map
points, Huber kernel, 4 rounds x 10 LM iterations with chi-square inlier
reclassification between rounds and the robust kernel dropped from round 3.
The reference's `fori_loop`s are Python loops with the same fixed counts;
accept/reject is a `torch.where`, so no iteration reads a value back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie
from .camera import Camera

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseObs(NamedTuple):
    uvr: torch.Tensor         # (N, 3) measured u, v, u_right (<0 => mono)
    xyz: torch.Tensor         # (N, 3) world points (fixed)
    inv_sigma2: torch.Tensor  # (N,)
    valid: torch.Tensor       # (N,) bool


def project_residual(cam: Camera, R, t, xyz, uvr):
    """Residual (N, 3): [du, dv, dur]; dur zeroed for mono features."""
    xc = lie.se3_apply(R, t, xyz)
    z = torch.clamp(xc[..., 2], min=1e-6)
    u = cam.fx * xc[..., 0] / z + cam.cx
    v = cam.fy * xc[..., 1] / z + cam.cy
    ur = u - cam.bf / z
    is_stereo = uvr[..., 2] >= 0
    r = torch.stack([u - uvr[..., 0], v - uvr[..., 1],
                     torch.where(is_stereo, ur - uvr[..., 2],
                                 torch.zeros_like(ur))], dim=-1)
    return r, xc


def pose_jacobian(cam: Camera, xc, is_stereo):
    """d(residual)/d(xi) for a left perturbation of Tcw: (N, 3, 6)."""
    x, y = xc[..., 0], xc[..., 1]
    z = torch.clamp(xc[..., 2], min=1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    zero = torch.zeros_like(z)
    du_dxc = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1)
    dv_dxc = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1)
    dur_dxc = du_dxc + torch.stack([zero, zero, cam.bf * iz2], -1)
    dr_dxc = torch.stack(
        [du_dxc, dv_dxc,
         torch.where(is_stereo[..., None], dur_dxc,
                     torch.zeros_like(dur_dxc))], -2)
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(
        xc.shape[:-1] + (3, 3))
    dxc_dxi = torch.cat([-lie.so3_hat(xc), eye], -1)
    return dr_dxc @ dxc_dxi


def huber_weight(chi2, delta2):
    """Huber IRLS weight: 1 if chi2 <= delta2 else delta / sqrt(chi2)."""
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


def pose_optimize(cam: Camera, R0, t0, obs: PoseObs,
                  n_rounds: int = 4, n_iters: int = 10):
    """Returns (R, t, inlier_mask (N,) bool, n_inliers int32 0-d)."""
    is_stereo = obs.uvr[..., 2] >= 0
    dt = obs.xyz.dtype
    dev = obs.xyz.device
    chi_th = torch.where(is_stereo, torch.tensor(CHI2_STEREO, dtype=dt,
                                                 device=dev),
                         torch.tensor(CHI2_MONO, dtype=dt, device=dev))
    delta2 = chi_th
    valid = obs.valid.to(dt)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def cost_of(R, t, use_robust, inlier):
        r, xc = project_residual(cam, R, t, obs.xyz, obs.uvr)
        chi2 = torch.sum(r * r, -1) * obs.inv_sigma2
        w_rob = huber_weight(chi2, delta2) if use_robust else 1.0
        front = (xc[..., 2] > 1e-6).to(dt)
        return torch.sum(chi2 * w_rob * inlier * valid * front), r, xc, chi2

    R, t = R0, t0
    inlier = torch.ones(obs.valid.shape, dtype=dt, device=dev)
    for rnd in range(n_rounds):
        use_robust = rnd < 2      # kernel dropped from round 3
        lam = torch.tensor(1e-2, dtype=dt, device=dev)
        for _ in range(n_iters):
            cost, r, xc, chi2 = cost_of(R, t, use_robust, inlier)
            J = pose_jacobian(cam, xc, is_stereo)
            w_rob = huber_weight(chi2, delta2) if use_robust else 1.0
            w = obs.inv_sigma2 * w_rob * inlier * valid
            w = torch.where(xc[..., 2] > 1e-6, w, torch.zeros_like(w))
            H = torch.einsum('nij,n,nik->jk', J, w, J)
            g = torch.einsum('nij,n,ni->j', J, w, r)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-10 * eye6
            dx = torch.linalg.solve_ex(Hd, -g)[0]   # no host sync
            dR, dtr = lie.se3_exp(dx)
            Rn, tn = lie.se3_compose(dR, dtr, R, t)
            costn = cost_of(Rn, tn, use_robust, inlier)[0]
            accept = costn < cost
            R = torch.where(accept, Rn, R)
            t = torch.where(accept, tn, t)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                              1e-8, 1e6)
        _, _, xc, chi2 = cost_of(R, t, False, inlier)
        inlier = ((chi2 <= chi_th) & (xc[..., 2] > 1e-6)).to(dt)
    n_inliers = torch.sum(inlier * valid).to(torch.int32)
    return R, t, (inlier > 0) & obs.valid, n_inliers
