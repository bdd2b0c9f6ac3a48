"""Sim(3) estimation: Horn closed form, RANSAC and two-view refinement.

Port of `orb_slam2_e_tpu/ops/sim3_solve.py` (reference Sim3Solver.cc and
Optimizer::OptimizeSim3).

- `ransac_sim3` is split into sampling and solving: `draw_sim3_sets` takes
  a `torch.Generator`, and `sets=` skips the draw, so a caller can pass in
  any three-point sets (the tests pass the reference's own).
- `umeyama_sim3` goes through a 3x3 SVD; R = U S Vt does not depend on the
  signs the SVD picks, so it is compared with the reference directly.
- `refine_sim3` takes the Jacobian of its (N, 4) residual in the 7 tangent
  parameters by forward-mode differentiation (`torch.func.jacfwd`), as the
  reference does with `jax.jacfwd`; `sim3_residual_jacobian` exposes it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie
from .orb import top_k


def umeyama_sim3(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                 fix_scale: bool = False):
    """Weighted closed-form similarity y ~ s R x + t. x, y: (..., N, 3);
    w: (..., N) nonnegative weights. Returns (R, t, s)."""
    wsum = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    mx = (x * w[..., None]).sum(-2) / wsum
    my = (y * w[..., None]).sum(-2) / wsum
    xc = (x - mx[..., None, :]) * w[..., None]
    yc = y - my[..., None, :]
    cov = yc.transpose(-1, -2) @ xc / wsum[..., None]        # (..., 3, 3)
    U, d, Vt = torch.linalg.svd(cov)
    sgn = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    diag = torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn], -1)
    R = (U * diag[..., None, :]) @ Vt
    var_x = (((x - mx[..., None, :]) ** 2) * w[..., None]).sum((-1, -2)) \
        / wsum[..., 0]
    if fix_scale:
        s = torch.ones_like(var_x)
    else:
        s = (d * diag).sum(-1) / torch.clamp(var_x, min=1e-12)
    t = my - s[..., None] * torch.einsum('...ij,...j->...i', R, mx)
    return R, t, s


class Sim3RansacResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    n_inliers: torch.Tensor
    inliers: torch.Tensor


def draw_sim3_sets(gen: torch.Generator, valid: torch.Tensor,
                   n_hyp: int = 128) -> torch.Tensor:
    """(n_hyp, 3) index sets, each three distinct valid correspondences
    drawn uniformly (Gumbel noise + top-3, as the reference draws them)."""
    u = torch.rand((n_hyp, valid.shape[0]), generator=gen,
                   device=valid.device)
    g = -torch.log(-torch.log(torch.clamp(u, min=1e-20, max=1.0 - 1e-7)))
    g = g + torch.where(valid, 0.0, -1e9)[None]
    return top_k(g, 3)[1]


def ransac_sim3(gen, xyz1: torch.Tensor, xyz2: torch.Tensor,
                valid: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
                K: torch.Tensor, fix_scale: bool = False, n_hyp: int = 128,
                th_px: float = 9.21 ** 0.5, sets=None) -> Sim3RansacResult:
    """RANSAC Sim3 from 3D-3D correspondences with reprojection-error
    inlier checks in both cameras (reference Sim3Solver::CheckInliers, chi2
    9.21). xyz1/xyz2: (N, 3) matched points in the frames of camera 1 and
    camera 2; uv1/uv2: (N, 2) their pixels. `sets` (n_hyp, 3) skips the
    draw from `gen`."""
    if sets is None:
        sets = draw_sim3_sets(gen, valid, n_hyp)
    sets = sets.long()
    w3 = torch.ones(sets.shape, dtype=xyz1.dtype, device=xyz1.device)
    # S12 per hypothesis: x1 ~ s R x2 + t
    Rs, ts, ss = umeyama_sim3(xyz2[sets], xyz1[sets], w3, fix_scale)

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def project(xc):
        z = torch.where(torch.abs(xc[..., 2]) < 1e-9,
                        torch.full_like(xc[..., 2], 1e-9), xc[..., 2])
        return torch.stack([fx * xc[..., 0] / z + cx,
                            fy * xc[..., 1] / z + cy], -1), xc[..., 2]

    x2_in_1 = ss[:, None, None] * torch.einsum('bij,nj->bni', Rs, xyz2) \
        + ts[:, None, :]
    uv1p, z1 = project(x2_in_1)
    x1_in_2 = torch.einsum('bij,bnj->bni', Rs.transpose(1, 2),
                           xyz1[None] - ts[:, None, :]) / ss[:, None, None]
    uv2p, z2 = project(x1_in_2)
    e1 = torch.sum((uv1p - uv1[None]) ** 2, -1)
    e2 = torch.sum((uv2p - uv2[None]) ** 2, -1)
    inl = ((e1 < th_px ** 2) & (e2 < th_px ** 2) & (z1 > 0) & (z2 > 0)
           & valid[None])
    counts = inl.sum(1)
    best = torch.argmax(counts)                    # first maximum
    # refine on the inliers with the weighted closed form
    Rr, tr, sr = umeyama_sim3(xyz2, xyz1, inl[best].to(xyz1.dtype),
                              fix_scale)
    return Sim3RansacResult(R=Rr, t=tr, s=sr, n_inliers=counts[best],
                            inliers=inl[best])


def _sim3_residuals(xi, R0, t0, s0, xyz1, xyz2, uv1, uv2, K,
                    inv_sigma2_1, inv_sigma2_2):
    """(N, 4) bidirectional reprojection residuals of exp(xi) * S0."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    # a batch of one: under `torch.func.jacfwd` a Python scalar times a
    # 0-d tensor is promoted to float64, so sim3_exp must see no 0-d value
    dR, dt, ds = (v[0] for v in lie.sim3_exp(xi[None]))
    R = dR @ R0
    s = ds * s0
    t = ds * (dR @ t0) + dt
    x2_in_1 = s * (xyz2 @ R.T) + t
    z1 = torch.clamp(x2_in_1[:, 2], min=1e-6)
    uv1p = torch.stack([fx * x2_in_1[:, 0] / z1 + cx,
                        fy * x2_in_1[:, 1] / z1 + cy], -1)
    x1_in_2 = ((xyz1 - t) @ R) / s
    z2 = torch.clamp(x1_in_2[:, 2], min=1e-6)
    uv2p = torch.stack([fx * x1_in_2[:, 0] / z2 + cx,
                        fy * x1_in_2[:, 1] / z2 + cy], -1)
    r1 = (uv1p - uv1) * torch.sqrt(inv_sigma2_1)[:, None]
    r2 = (uv2p - uv2) * torch.sqrt(inv_sigma2_2)[:, None]
    return torch.cat([r1, r2], dim=1)


def sim3_residual_jacobian(xi, R0, t0, s0, xyz1, xyz2, uv1, uv2, K,
                           inv_sigma2_1, inv_sigma2_2):
    """The refinement's residual (N, 4) and its Jacobian (N, 4, 7) in the
    tangent `xi`, by forward-mode differentiation."""
    def f(x):
        r = _sim3_residuals(x, R0, t0, s0, xyz1, xyz2, uv1, uv2, K,
                            inv_sigma2_1, inv_sigma2_2)
        return r, r

    J, r = torch.func.jacfwd(f, has_aux=True)(xi)
    return r, J


def refine_sim3(R0, t0, s0, xyz1, xyz2, valid, uv1, uv2, K,
                inv_sigma2_1, inv_sigma2_2, fix_scale: bool = False,
                n_iters: int = 10, chi2_th: float = 10.0):
    """Gauss-Newton refinement of S12 on the bidirectional reprojection
    error with an outlier drop after every step (reference
    Optimizer::OptimizeSim3). Returns (R, t, s, n_inliers, inlier_mask)."""
    dt_, dev = xyz1.dtype, xyz1.device
    args = (R0, t0, s0, xyz1, xyz2, uv1, uv2, K, inv_sigma2_1, inv_sigma2_2)
    damp = 1e-6 * torch.eye(7, dtype=dt_, device=dev)
    if fix_scale:
        damp[6, 6] += 1e9
    xi = torch.zeros((7,), dtype=dt_, device=dev)
    inlier = valid
    for _ in range(n_iters):
        r, J = sim3_residual_jacobian(xi, *args)
        w = (inlier & valid).to(dt_)
        H = torch.einsum('nij,n,nik->jk', J, w, J) + damp
        g = torch.einsum('nij,n,ni->j', J, w, r)
        xi = xi + torch.linalg.solve_ex(H, -g)[0]
        r = _sim3_residuals(xi, *args)
        chi2 = torch.sum(r[:, :2] ** 2, 1) + torch.sum(r[:, 2:] ** 2, 1)
        inlier = chi2 < 2 * chi2_th
    dR, dt, ds = lie.sim3_exp(xi)
    keep = inlier & valid
    return dR @ R0, ds * (dR @ t0) + dt, ds * s0, keep.sum(), keep
