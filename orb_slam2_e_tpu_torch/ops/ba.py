"""Bundle adjustment: Levenberg-Marquardt over cameras + landmarks with
Schur-complement elimination, in two flavors.

Port of `orb_slam2_e_tpu/ops/ba.py`:
- `ba_solve` (dense Schur, reference Optimizer::LocalBundleAdjustment): two
  LM phases with outlier reclassification between them, Huber kernels in
  phase 1, the seed-state gross-outlier gate, the delayed-accept LM loop,
  and the reduced camera system solved by 32 Jacobi-preconditioned CG
  iterations;
- `ba_solve_pcg` / `ba_pcg_chunk` (matrix-free Schur, reference
  Optimizer::GlobalBundleAdjustemnt): S x is computed from the observation
  arrays with scatter-adds and solved by block-Jacobi-preconditioned CG.
  `ba_pcg_chunk` runs a bounded number of LM iterations from a carry, the
  unit of the chunked global BA. This path is float32 throughout.

Arithmetic choices, matching the reference:
- everything is float32 with TF32 off, including the one-hot camera
  aggregation the reference pins to HIGHEST;
- the big Schur product A A^T takes bf16-rounded operands and accumulates
  in float32, as the reference's bf16 x bf16 -> f32 dot does: A is rounded
  to bf16 and back, then multiplied in f32 (products of bf16 values are
  exact in f32);
- the seed gate's median averages the two middle values, as
  `jnp.nanmedian` does (`torch.nanmedian` would return the lower one);
- point sums are `index_add_`: on the card its atomics add in a varying
  order, so results agree with the reference within a tolerance, not bit
  for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie
from .camera import Camera
from .pose_opt import CHI2_MONO, CHI2_STEREO, huber_weight


class BAProblem(NamedTuple):
    cam_pose7: torch.Tensor       # (C, 7) Tcw quaternion+translation
    cam_free: torch.Tensor        # (C,) bool; False = gauge/fixed ring
    points: torch.Tensor          # (P, 3)
    point_valid: torch.Tensor     # (P,) bool
    obs_cam: torch.Tensor         # (O,) int
    obs_point: torch.Tensor       # (O,) int
    obs_uvr: torch.Tensor         # (O, 3)
    obs_inv_sigma2: torch.Tensor  # (O,)
    obs_valid: torch.Tensor       # (O,) bool


class BAResult(NamedTuple):
    cam_pose7: torch.Tensor
    points: torch.Tensor
    obs_inlier: torch.Tensor      # (O,) bool
    final_cost: torch.Tensor


def _residual_jacobians(cam: Camera, R, t, prob: BAProblem):
    """Residual (O,3), camera Jacobian (O,3,6), point Jacobian (O,3,3),
    behind-camera mask (O,)."""
    oc = prob.obs_cam.long()
    Ro = R[oc]
    to = t[oc]
    Xw = prob.points[prob.obs_point.long()]
    xc = torch.einsum('oij,oj->oi', Ro, Xw) + to
    z = torch.clamp(xc[:, 2], min=1e-6)
    u = cam.fx * xc[:, 0] / z + cam.cx
    v = cam.fy * xc[:, 1] / z + cam.cy
    ur = u - cam.bf / z
    is_stereo = prob.obs_uvr[:, 2] >= 0
    zeros = torch.zeros_like(z)
    r = torch.stack([u - prob.obs_uvr[:, 0], v - prob.obs_uvr[:, 1],
                     torch.where(is_stereo, ur - prob.obs_uvr[:, 2], zeros)],
                    -1)
    iz = 1.0 / z
    iz2 = iz * iz
    du = torch.stack([cam.fx * iz, zeros, -cam.fx * xc[:, 0] * iz2], -1)
    dv = torch.stack([zeros, cam.fy * iz, -cam.fy * xc[:, 1] * iz2], -1)
    dur = du + torch.stack([zeros, zeros, cam.bf * iz2], -1)
    dr_dxc = torch.stack([du, dv, torch.where(is_stereo[:, None], dur,
                                              torch.zeros_like(dur))], -2)
    Jc = torch.cat([torch.einsum('oij,ojk->oik', dr_dxc, -lie.so3_hat(xc)),
                    dr_dxc], -1)
    Jp = torch.einsum('oij,ojk->oik', dr_dxc, Ro)
    behind = xc[:, 2] <= 1e-6
    return r, Jc, Jp, behind


def _chi2_thresholds(prob: BAProblem):
    is_stereo = prob.obs_uvr[:, 2] >= 0
    one = torch.ones_like(prob.obs_inv_sigma2)
    return torch.where(is_stereo, CHI2_STEREO * one, CHI2_MONO * one)


def _weights(prob: BAProblem, r, behind, robust: bool, extra_mask=None):
    chi2 = torch.sum(r * r, -1) * prob.obs_inv_sigma2
    w_rob = (huber_weight(chi2, _chi2_thresholds(prob)) if robust
             else torch.ones_like(chi2))
    live = prob.obs_valid & prob.point_valid[prob.obs_point.long()] & ~behind
    if extra_mask is not None:
        live = live & extra_mask
    w = prob.obs_inv_sigma2 * w_rob * live
    cost = torch.sum(torch.where(live, chi2 * w_rob, torch.zeros_like(chi2)))
    return w, chi2, cost, live


def _build_normal_blocks(prob: BAProblem, r, Jc, Jp, w, C: int, P: int):
    """Per-observation products -> Hcc (C,6,6), bc (C,6), Hpp (P,3,3),
    bp (P,3). Cameras through a (C, O) one-hot matmul, points through an
    index_add over the point-sorted observations."""
    O = r.shape[0]
    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]
    onehot_c = (prob.obs_cam[None, :].long()
                == torch.arange(C, device=r.device)[:, None]).to(r.dtype)
    vals_c = torch.cat([
        torch.einsum('oij,oik->ojk', wJc, Jc).reshape(O, 36),
        torch.einsum('oij,oi->oj', wJc, r)], -1)
    agg_c = onehot_c @ vals_c
    Hcc = agg_c[:, :36].reshape(C, 6, 6)
    bc = agg_c[:, 36:]
    vals_p = torch.cat([
        torch.einsum('oij,oik->ojk', wJp, Jp).reshape(O, 9),
        torch.einsum('oij,oi->oj', wJp, r)], -1)
    agg_p = torch.zeros((P, 12), dtype=r.dtype, device=r.device).index_add_(
        0, prob.obs_point.long(), vals_p)
    return Hcc, bc, agg_p[:, :9].reshape(P, 3, 3), agg_p[:, 9:]


def _chol3x3(M):
    """Closed-form batched Cholesky of SPD 3x3 blocks (lower L)."""
    eps = 1e-12
    a = torch.sqrt(torch.clamp(M[..., 0, 0], min=eps))
    b = M[..., 1, 0] / a
    c = M[..., 2, 0] / a
    d = torch.sqrt(torch.clamp(M[..., 1, 1] - b * b, min=eps))
    e = (M[..., 2, 1] - c * b) / d
    f = torch.sqrt(torch.clamp(M[..., 2, 2] - c * c - e * e, min=eps))
    z = torch.zeros_like(a)
    return torch.stack([torch.stack([a, z, z], -1),
                        torch.stack([b, d, z], -1),
                        torch.stack([c, e, f], -1)], -2)


def _inv3x3(M):
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12,
                                torch.full_like(det, 1e-12), det)
    row0 = torch.stack([A, -(b * i - c * h), b * f - c * e], -1)
    row1 = torch.stack([B, a * i - c * g, -(a * f - c * d)], -1)
    row2 = torch.stack([C, -(a * h - b * g), a * e - b * d], -1)
    return torch.stack([row0, row1, row2], -2) * inv_det[..., None, None]


def _spd_solve_cg(S, b, iters: int = 32):
    """Jacobi-preconditioned CG for the damped reduced camera system, a
    fixed number of iterations (the reference's fori_loop)."""
    d = torch.clamp(torch.diagonal(S), min=1e-12)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    x = torch.zeros_like(b)
    r = b
    p = b / d
    rz = torch.dot(b, p)
    for _ in range(iters):
        Ap = S @ p
        denom = torch.dot(p, Ap)
        alpha = torch.where(torch.abs(denom) > 1e-20, rz / denom, zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = r / d
        rz2 = torch.dot(r, z)
        beta = torch.where(torch.abs(rz) > 1e-20, rz2 / rz, zero)
        p = z + beta * p
        rz = rz2
    return x


def _schur_solve_dense(prob: BAProblem, Hcc, bc, Hpp, bp, Jc, Jp, w,
                       cam_free, lam):
    """Marginalize points, solve the reduced camera system, back-substitute
    (symmetric factored form of the reference). Returns (dxc (C,6),
    dxp (P,3))."""
    C = Hcc.shape[0]
    P = Hpp.shape[0]
    O = w.shape[0]
    dev, dt = Hcc.device, Hcc.dtype
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    Hpp_l = (Hpp + lam * torch.diag_embed(Hpp.diagonal(dim1=1, dim2=2))
             + 1e-9 * eye3)
    L = _chol3x3(_inv3x3(Hpp_l))                           # (P, 3, 3)
    op = prob.obs_point.long()
    wJc = Jc * w[:, None, None]
    zvals = torch.einsum('oij,oik,okl->ojl', wJc, Jp, L[op])   # (O, 6, 3)
    flat = op * C + prob.obs_cam.long()
    Z = torch.zeros((P * C, 18), dtype=dt, device=dev).index_add_(
        0, flat, zvals.reshape(O, 18)).reshape(P, C, 6, 3)
    A = Z.permute(1, 2, 0, 3).reshape(C * 6, P * 3)
    Ab = A.to(torch.bfloat16).to(dt)          # bf16 operands, f32 sums
    S_off = (Ab @ Ab.T).reshape(C, 6, C, 6).permute(0, 2, 1, 3)
    Ltb = torch.einsum('pji,pj->pi', L, bp)                 # L^T bp
    rhs_red = bc - (A @ Ltb.reshape(-1)).reshape(C, 6)
    ar = torch.arange(C, device=dev)
    S = -S_off
    S[ar, ar] += Hcc + lam * torch.diag_embed(Hcc.diagonal(dim1=1, dim2=2))
    free = cam_free.to(dt)
    S = S * free[:, None, None, None] * free[None, :, None, None]
    S[ar, ar] += (1.0 - free)[:, None, None] * eye6
    rhs_red = rhs_red * free[:, None]
    Sf = S.permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
    dxc = _spd_solve_cg(Sf, -rhs_red.reshape(-1)).reshape(C, 6)
    dxc = dxc * free[:, None]
    v = (dxc.reshape(-1) @ A).reshape(P, 3)                 # Z^T dxc
    dxp = -torch.einsum('pij,pj->pi', L, Ltb + v)
    return dxc, dxp


def _apply_updates(cam_pose7, points, dxc, dxp, point_valid):
    R, t = lie.pose7_unpack(cam_pose7)
    dR, dt = lie.se3_exp(dxc)
    Rn, tn = lie.se3_compose(dR, dt, R, t)
    pts_n = torch.where(point_valid[:, None], points + dxp, points)
    return lie.pose7_pack(Rn, tn), pts_n


def _nanmedian_mid(x: torch.Tensor) -> torch.Tensor:
    """Median ignoring NaNs, averaging the two middle values for an even
    count (`jnp.nanmedian`); NaN when every value is NaN."""
    return torch.nanquantile(x, 0.5)


def ba_solve(cam: Camera, prob: BAProblem, iters_phase1: int = 5,
             iters_phase2: int = 10, extra_cost_fn=None) -> BAResult:
    """Dense-Schur LM bundle adjustment with outlier reclassification
    between the two phases (reference Optimizer.cc:1003-1033).

    `extra_cost_fn(points) -> scalar` is added to the cost of every trial,
    the trailing one of each phase included, before the accept/reject test;
    the normal equations stay reprojection-only. This is how the deformable
    mode puts the FEM strain energy into the optimization (the reference's
    modified g2o LM, optimization_algorithm_levenberg.cpp:145-199)."""
    C = prob.cam_pose7.shape[0]
    P = prob.points.shape[0]
    if P * C >= 2 ** 31:
        raise ValueError("BA capacity overflow: P*C must fit in int32")
    dt = prob.points.dtype
    dev = prob.points.device

    # sort observations by (point, cam) once, as the reference does; the
    # final classification is made in the caller's order
    order = torch.argsort(prob.obs_point.long() * C + prob.obs_cam.long(),
                          stable=True)
    prob_in = prob
    prob = prob._replace(
        obs_cam=prob.obs_cam[order], obs_point=prob.obs_point[order],
        obs_uvr=prob.obs_uvr[order],
        obs_inv_sigma2=prob.obs_inv_sigma2[order],
        obs_valid=prob.obs_valid[order])
    O = prob.obs_cam.shape[0]

    def evaluate(pose7, pts, robust, extra_mask):
        R, t = lie.pose7_unpack(pose7)
        p = prob._replace(cam_pose7=pose7, points=pts)
        r, Jc, Jp, behind = _residual_jacobians(cam, R, t, p)
        w, _, cost, _ = _weights(p, r, behind, robust, extra_mask)
        if extra_cost_fn is not None:
            cost = cost + extra_cost_fn(pts)
        return r, Jc, Jp, w, cost

    def run_phase(pose7, pts, lam, n_iters, robust, extra_mask):
        """Delayed-accept LM: each iteration evaluates the previous
        iteration's trial step and falls back to the cached linearization
        of the last accepted state on rejection."""
        pose_b, pts_b = pose7, pts
        cost_b = torch.tensor(float("inf"), dtype=dt, device=dev)
        r_b = torch.zeros((O, 3), dtype=dt, device=dev)
        Jc_b = torch.zeros((O, 3, 6), dtype=dt, device=dev)
        Jp_b = torch.zeros((O, 3, 3), dtype=dt, device=dev)
        w_b = torch.zeros((O,), dtype=dt, device=dev)
        pose_t, pts_t = pose7, pts
        for _ in range(n_iters):
            r, Jc, Jp, w, cost_t = evaluate(pose_t, pts_t, robust,
                                            extra_mask)
            accept = cost_t < cost_b
            seed_eval = ~torch.isfinite(cost_b)
            pose_b = torch.where(accept, pose_t, pose_b)
            pts_b = torch.where(accept, pts_t, pts_b)
            cost_b = torch.where(accept, cost_t, cost_b)
            r_b = torch.where(accept, r, r_b)
            Jc_b = torch.where(accept, Jc, Jc_b)
            Jp_b = torch.where(accept, Jp, Jp_b)
            w_b = torch.where(accept, w, w_b)
            lam = torch.where(seed_eval, lam, torch.clamp(
                torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6))
            pb = prob._replace(cam_pose7=pose_b, points=pts_b)
            Hcc, bc, Hpp, bp = _build_normal_blocks(pb, r_b, Jc_b, Jp_b,
                                                    w_b, C, P)
            dxc, dxp = _schur_solve_dense(pb, Hcc, bc, Hpp, bp, Jc_b, Jp_b,
                                          w_b, prob.cam_free, lam)
            pose_t, pts_t = _apply_updates(pose_b, pts_b, dxc, dxp,
                                           prob.point_valid)
        # resolve the trailing trial: keep it if it improved the cost
        cost_t = evaluate(pose_t, pts_t, robust, extra_mask)[4]
        accept = cost_t < cost_b
        return (torch.where(accept, pose_t, pose_b),
                torch.where(accept, pts_t, pts_b), lam)

    # gross-outlier gate at the seed state (phase 1 only)
    R0, t0 = lie.pose7_unpack(prob.cam_pose7)
    r0, _, _, behind0 = _residual_jacobians(cam, R0, t0, prob)
    chi2_0 = torch.sum(r0 * r0, -1) * prob.obs_inv_sigma2
    live0 = (prob.obs_valid & prob.point_valid[prob.obs_point.long()]
             & ~behind0)
    med0 = _nanmedian_mid(torch.where(live0, chi2_0,
                                      torch.full_like(chi2_0, float("nan"))))
    med0 = torch.where(torch.isnan(med0), torch.zeros_like(med0), med0)
    gross_th = torch.maximum(32.0 * _chi2_thresholds(prob), 25.0 * med0)
    gross_mask = (chi2_0 <= gross_th) & ~behind0

    lam0 = torch.tensor(1e-4, dtype=dt, device=dev)
    pose7, pts, lam = run_phase(prob.cam_pose7, prob.points, lam0,
                                iters_phase1, True, gross_mask)

    # reclassify outliers
    R, t = lie.pose7_unpack(pose7)
    p = prob._replace(cam_pose7=pose7, points=pts)
    r, _, _, behind = _residual_jacobians(cam, R, t, p)
    chi2 = torch.sum(r * r, -1) * prob.obs_inv_sigma2
    inlier_mask = (chi2 <= _chi2_thresholds(prob)) & ~behind

    pose7, pts, lam = run_phase(pose7, pts, lam, iters_phase2, False,
                                inlier_mask)

    # final classification in the caller's observation order
    R, t = lie.pose7_unpack(pose7)
    p = prob_in._replace(cam_pose7=pose7, points=pts)
    r, _, _, behind = _residual_jacobians(cam, R, t, p)
    chi2 = torch.sum(r * r, -1) * prob_in.obs_inv_sigma2
    final_inlier = ((chi2 <= _chi2_thresholds(prob_in)) & ~behind
                    & prob_in.obs_valid)
    _, _, cost, _ = _weights(p, r, behind, False, None)
    return BAResult(cam_pose7=pose7, points=pts, obs_inlier=final_inlier,
                    final_cost=cost)


# ---------------------------------------------------------------------------
# Matrix-free Schur PCG (global BA)
# ---------------------------------------------------------------------------

def _scatter_rows(n: int, idx: torch.Tensor, vals: torch.Tensor):
    """`zeros((n,) + vals.shape[1:]).at[idx].add(vals)`."""
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, idx, vals)


def _schur_matvec(x, prob: BAProblem, Jc, Jp, w, Hcc_l, Hpp_inv, psum=None):
    """S @ x without materializing S. x: (C, 6). `psum` is the collective
    of the sharded path (applied to the point-space and camera-space
    partial sums); None on one device."""
    C = x.shape[0]
    P = Hpp_inv.shape[0]
    oc, op = prob.obs_cam.long(), prob.obs_point.long()
    Jcx = torch.einsum('oij,oj->oi', Jc, x[oc])                   # (O, 3)
    y = _scatter_rows(P, op, torch.einsum('oij,oi->oj',
                                          Jp * w[:, None, None], Jcx))
    if psum is not None:
        y = psum(y)
    z = torch.einsum('pij,pj->pi', Hpp_inv, y)                    # (P, 3)
    Jpz = torch.einsum('oij,oj->oi', Jp, z[op])                   # (O, 3)
    wc = _scatter_rows(C, oc, torch.einsum('oij,oi->oj',
                                           Jc * w[:, None, None], Jpz))
    if psum is not None:
        wc = psum(wc)
    return torch.einsum('cij,cj->ci', Hcc_l, x) - wc


def _pcg_lm_step(cam: Camera, prob: BAProblem, carry, cg_iters: int,
                 robust: bool, psum):
    """One LM iteration of the matrix-free Schur PCG solver; carry =
    (cam_pose7, points, lambda). Returns (carry', cost of the trial)."""
    C = prob.cam_pose7.shape[0]
    P = prob.points.shape[0]
    pose7, pts, lam = carry
    dt, dev = pts.dtype, pts.device
    oc, op = prob.obs_cam.long(), prob.obs_point.long()
    R, t = lie.pose7_unpack(pose7)
    p = prob._replace(cam_pose7=pose7, points=pts)
    r, Jc, Jp, behind = _residual_jacobians(cam, R, t, p)
    w, _, cost, _ = _weights(p, r, behind, robust)
    if psum is not None:
        cost = psum(cost)       # accept/reject must agree across shards
    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]
    Hcc = _scatter_rows(C, oc, torch.einsum('oij,oik->ojk', wJc, Jc))
    bc = _scatter_rows(C, oc, torch.einsum('oij,oi->oj', wJc, r))
    Hpp = _scatter_rows(P, op, torch.einsum('oij,oik->ojk', wJp, Jp))
    bp = _scatter_rows(P, op, torch.einsum('oij,oi->oj', wJp, r))
    if psum is not None:
        Hcc, bc, Hpp, bp = psum(Hcc), psum(bc), psum(Hpp), psum(bp)
    Hcc_l = Hcc + torch.diag_embed(
        lam * Hcc.diagonal(dim1=1, dim2=2) + 1e-8)
    Hpp_l = Hpp + torch.diag_embed(
        lam * Hpp.diagonal(dim1=1, dim2=2) + 1e-8)
    Hpp_inv = _inv3x3(Hpp_l)
    # rhs = -(bc - Hcp Hpp^-1 bp); gauge: zero rhs of the fixed cameras
    z0 = torch.einsum('pij,pj->pi', Hpp_inv, bp)
    Jpz = torch.einsum('oij,oj->oi', Jp, z0[op])
    red = _scatter_rows(C, oc, torch.einsum('oij,oi->oj', wJc, Jpz))
    if psum is not None:
        red = psum(red)
    free = prob.cam_free.to(dt)[:, None]
    rhs = -(bc - red) * free

    # block-Jacobi preconditioner
    M_inv = torch.linalg.inv_ex(
        Hcc_l + torch.eye(6, dtype=dt, device=dev) * 1e-6)[0]

    def matvec(x):
        return _schur_matvec(x * free, prob, Jc, Jp, w, Hcc_l, Hpp_inv,
                             psum) * free

    def prec(x):
        return torch.einsum('cij,cj->ci', M_inv, x) * free

    # PCG, a fixed number of iterations, masked dofs
    zero = torch.zeros((), dtype=dt, device=dev)
    x = torch.zeros_like(rhs)
    rcg = rhs - matvec(x)
    zc = prec(rcg)
    pdir = zc
    rz = torch.sum(rcg * zc)
    for _ in range(cg_iters):
        Ap = matvec(pdir)
        denom = torch.sum(pdir * Ap)
        alpha = torch.where(torch.abs(denom) > 1e-12, rz / denom, zero)
        x = x + alpha * pdir
        rcg = rcg - alpha * Ap
        zc = prec(rcg)
        rz_new = torch.sum(rcg * zc)
        beta = torch.where(torch.abs(rz) > 1e-12, rz_new / rz, zero)
        pdir = zc + beta * pdir
        rz = rz_new
    dxc = x * free
    Jcx = torch.einsum('oij,oj->oi', Jc, dxc[oc])
    yb = _scatter_rows(P, op, torch.einsum('oij,oi->oj', wJp, Jcx))
    if psum is not None:
        yb = psum(yb)
    dxp = -torch.einsum('pij,pj->pi', Hpp_inv, bp + yb)

    pose_n, pts_n = _apply_updates(pose7, pts, dxc, dxp, prob.point_valid)
    Rn, tn = lie.pose7_unpack(pose_n)
    pn = prob._replace(cam_pose7=pose_n, points=pts_n)
    rn, _, _, behind_n = _residual_jacobians(cam, Rn, tn, pn)
    cost_n = _weights(pn, rn, behind_n, robust)[2]
    if psum is not None:
        cost_n = psum(cost_n)
    accept = cost_n < cost
    pose7 = torch.where(accept, pose_n, pose7)
    pts = torch.where(accept, pts_n, pts)
    lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
    return (pose7, pts, lam), cost_n


def ba_pcg_carry_init(prob: BAProblem):
    """Initial (pose, points, lambda) carry of the chunked PCG bundle
    adjustment."""
    return (prob.cam_pose7, prob.points,
            torch.tensor(1e-4, dtype=prob.points.dtype,
                         device=prob.points.device))


def ba_pcg_chunk(cam: Camera, prob: BAProblem, carry, n_outer: int = 2,
                 cg_iters: int = 30, robust: bool = True):
    """Run `n_outer` LM iterations of the matrix-free PCG solver from
    `carry` and return the new carry: the bounded unit of work of the
    abortable global BA (one chunk rides behind each tracked frame;
    dropping the carry aborts). Nothing in a chunk is read by the host."""
    for _ in range(n_outer):
        carry, _ = _pcg_lm_step(cam, prob, carry, cg_iters, robust, None)
    return carry


def ba_solve_pcg(cam: Camera, prob: BAProblem, n_outer: int = 10,
                 cg_iters: int = 30, robust: bool = True,
                 psum=None) -> BAResult:
    """LM with the matrix-free Schur product and a block-Jacobi PCG camera
    solve. `psum` sums a partial result over the ranks that share the
    observations (`parallel.dist_ba.distributed_ba` passes an all-reduce);
    None on one device."""
    carry = ba_pcg_carry_init(prob)
    for _ in range(n_outer):
        carry, _ = _pcg_lm_step(cam, prob, carry, cg_iters, robust, psum)
    pose7, pts, _ = carry
    R, t = lie.pose7_unpack(pose7)
    p = prob._replace(cam_pose7=pose7, points=pts)
    r, _, _, behind = _residual_jacobians(cam, R, t, p)
    chi2 = torch.sum(r * r, -1) * prob.obs_inv_sigma2
    final_inlier = ((chi2 <= _chi2_thresholds(prob)) & ~behind
                    & prob.obs_valid)
    cost = _weights(p, r, behind, False)[2]
    if psum is not None:
        cost = psum(cost)
    return BAResult(cam_pose7=pose7, points=pts, obs_inlier=final_inlier,
                    final_cost=cost)
