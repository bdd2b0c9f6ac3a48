"""Plain local bundle adjustment: the check of the mapping pass.

ORB-SLAM2's local BA (Optimizer::LocalBundleAdjustment) over one window,
written out in plain torch with an exact Schur solve: a robust phase
(Huber kernel, g2o's rho), the observations reclassified by the chi-square
test, then a plain phase over the inliers; Levenberg-Marquardt with
Marquardt's diagonal damping (1e-4, halved on a step that lowers the cost,
times four on one that does not). The schedule is the one the configured
system runs (3 robust and 4 plain iterations, and the gross-outlier gate
at the start: 32 times the chi-square threshold or 25 times the median).
A free keyframe with no live observation in a step (its observations
gated out, behind it, or clipped from the program's problem by its
capacity) leaves its block of the reduced camera system zero: it is held
in that step, since the cost does not depend on it.

The window (which keyframes are free, which are held, which landmarks and
observations it holds) is read from the problem the program built; the
landmarks and poses it starts from and those the program wrote back are
the program's. `shortfall` judges the program's result: the share of the
reference's decrease of the window's truncated cost (each observation's
chi-square, at most its inlier threshold) that it did not reach. Nothing
here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import CHI2_MONO, CHI2_STEREO, hat, so3_exp

ITERS = (3, 4)
GROSS = (32.0, 25.0)


class Window:
    """One local BA's problem, its start and the program's result, moved to
    the reference's device: R (C, 3, 3), t (C, 3), X (P, 3) float64."""

    def __init__(self, prob: dict, start, result, device):
        d = torch.device(device)
        self.free = prob["cam_free"].to(d).bool()
        self.point_valid = prob["point_valid"].to(d).bool()
        self.oc = prob["obs_cam"].to(d).long()
        self.op = prob["obs_point"].to(d).long()
        self.uvr = prob["obs_uvr"].to(d).double()
        self.inv_s2 = prob["obs_inv_sigma2"].to(d).double()
        self.valid = (prob["obs_valid"].to(d).bool()
                      & self.point_valid[self.op])
        self.th = torch.where(self.uvr[:, 2] >= 0, CHI2_STEREO, CHI2_MONO
                              ).to(torch.float64)
        self.start = tuple(s.to(d).double() for s in start)
        self.result = tuple(s.to(d).double() for s in result)


def residuals(cam, w: Window, R, t, X):
    """(O, 3) residuals and (O, 3) camera-frame points."""
    fx, fy, cx, cy, bf = cam
    xc = torch.einsum("oij,oj->oi", R[w.oc], X[w.op]) + t[w.oc]
    z = torch.clamp(xc[:, 2], min=1e-6)
    u = fx * xc[:, 0] / z + cx
    v = fy * xc[:, 1] / z + cy
    stereo = w.uvr[:, 2] >= 0
    ur = torch.where(stereo, u - bf / z - w.uvr[:, 2].to(u.dtype),
                     torch.zeros_like(u))
    return torch.stack([u - w.uvr[:, 0].to(u.dtype),
                        v - w.uvr[:, 1].to(u.dtype), ur], -1), xc


def chi2(cam, w: Window, R, t, X):
    r, xc = residuals(cam, w, R, t, X)
    return ((r * r).sum(-1).double() * w.inv_s2, xc[:, 2] > 1e-6)


def cost(cam, w: Window, state) -> float:
    """The truncated cost of `state` (R, t, X) in float64: over the
    window's observations, each one's chi-square, and its inlier threshold
    where it is above it or behind the camera, so that no single
    observation that one side counts as an outlier outweighs the rest."""
    R, t, X = (s.double() for s in state)
    c2, front = chi2(cam, w, R, t, X)
    c2 = torch.where(front, torch.minimum(c2, w.th), w.th)
    return float(torch.where(w.valid, c2, torch.zeros_like(c2)).sum())


def _lm_phase(cam, w: Window, state, lam, n_iters, robust, gate, dtype):
    solve_dt = torch.float64 if dtype == torch.float64 else torch.float32
    C, P, O = state[0].shape[0], state[2].shape[0], w.oc.shape[0]
    dev = state[2].device
    fx, fy = cam[0], cam[1]
    bf = cam[4]
    inv_s2 = w.inv_s2.to(dtype)

    def evaluate(R, t, X):
        c2, front = chi2(cam, w, R, t, X)
        live = w.valid & gate & front
        if robust:
            rho = torch.where(c2 <= w.th, c2,
                              2 * torch.sqrt(w.th * c2) - w.th)
            wt = torch.where(c2 <= w.th, torch.ones_like(c2),
                             torch.sqrt(w.th / torch.clamp(c2, min=1e-12)))
        else:
            rho, wt = c2, torch.ones_like(c2)
        return float(torch.where(live, rho, torch.zeros_like(rho)).sum()), \
            (inv_s2 * wt.to(dtype) * live.to(dtype))

    def step(R, t, X, wo, lam):
        r, xc = residuals(cam, w, R, t, X)
        z = torch.clamp(xc[:, 2], min=1e-6)
        iz = 1.0 / z
        zero = torch.zeros_like(z)
        du = torch.stack([fx * iz, zero, -fx * xc[:, 0] * iz * iz], -1)
        dv = torch.stack([zero, fy * iz, -fy * xc[:, 1] * iz * iz], -1)
        dur = du + torch.stack([zero, zero, bf * iz * iz], -1)
        stereo = (w.uvr[:, 2] >= 0)[:, None]
        dr = torch.stack([du, dv, torch.where(stereo, dur,
                                              torch.zeros_like(dur))], -2)
        eye3 = torch.eye(3, dtype=dtype, device=dev).expand(O, 3, 3)
        Jc = (dr @ torch.cat([-hat(xc), eye3], -1)).to(solve_dt)
        Jp = (dr @ R[w.oc]).to(solve_dt)
        rs, ws = r.to(solve_dt), wo.to(solve_dt)
        wJc = Jc * ws[:, None, None]
        wJp = Jp * ws[:, None, None]
        Hcc = torch.zeros(C, 6, 6, dtype=solve_dt, device=dev).index_add_(
            0, w.oc, wJc.transpose(1, 2) @ Jc)
        bc = torch.zeros(C, 6, dtype=solve_dt, device=dev).index_add_(
            0, w.oc, torch.einsum("oij,oi->oj", wJc, rs))
        Hpp = torch.zeros(P, 3, 3, dtype=solve_dt, device=dev).index_add_(
            0, w.op, wJp.transpose(1, 2) @ Jp)
        bp = torch.zeros(P, 3, dtype=solve_dt, device=dev).index_add_(
            0, w.op, torch.einsum("oij,oi->oj", wJp, rs))
        W = torch.zeros(C * P, 6, 3, dtype=solve_dt, device=dev).index_add_(
            0, w.oc * P + w.op, wJc.transpose(1, 2) @ Jp).view(C, P, 6, 3)
        eye = torch.eye(3, dtype=solve_dt, device=dev)
        Hpp_l = (Hpp + lam * torch.diag_embed(Hpp.diagonal(dim1=1, dim2=2))
                 + 1e-9 * eye)
        Hinv = torch.linalg.inv(Hpp_l)
        V = W @ Hinv                                       # (C, P, 6, 3)
        S = -torch.einsum("cpij,dplj->cdil", V, W)
        ar = torch.arange(C, device=dev)
        S[ar, ar] += Hcc + lam * torch.diag_embed(
            Hcc.diagonal(dim1=1, dim2=2))
        rhs = -bc + torch.einsum("cpij,pj->ci", V, bp)
        # a free keyframe with no live observation in this step has a zero
        # block and row in S (the cost does not depend on it): it stays
        seen = torch.zeros(C, dtype=torch.bool, device=dev)
        seen[w.oc[wo != 0]] = True
        free = torch.nonzero(w.free & seen).flatten()
        Sf = S[free][:, free].permute(0, 2, 1, 3).reshape(
            6 * len(free), 6 * len(free))
        dxc = torch.zeros(C, 6, dtype=solve_dt, device=dev)
        if len(free):
            dxc[free] = torch.linalg.solve(
                Sf, rhs[free].reshape(-1)).reshape(-1, 6)
        dxp = -torch.einsum("pij,pj->pi", Hinv,
                            bp + torch.einsum("cpij,ci->pj", W, dxc))
        dxc, dxp = dxc.to(dtype), dxp.to(dtype)
        dR = so3_exp(dxc[:, :3])
        Rn = dR @ R
        tn = torch.einsum("cij,cj->ci", dR, t) + dxc[:, 3:]
        Xn = torch.where(w.point_valid[:, None], X + dxp, X)
        return Rn, tn, Xn

    R, t, X = state
    c_b, wo = evaluate(R, t, X)
    for k in range(n_iters):
        Rn, tn, Xn = step(R, t, X, wo, lam)
        c_t, wo_t = evaluate(Rn, tn, Xn)
        accept = c_t < c_b
        if accept:
            R, t, X, c_b, wo = Rn, tn, Xn, c_t, wo_t
        if k < n_iters - 1:
            lam = min(max(lam * (0.5 if accept else 4.0), 1e-9), 1e6)
    return (R, t, X), lam


def local_ba(cam, w: Window, dtype=torch.float64):
    """The reference's local BA from the window's start, in `dtype` (the
    linear solves in float32 at least). Returns ((R, t, X) in float64, the
    inliers of the plain phase (O,) bool)."""
    R, t, X = (s.to(dtype) for s in w.start)
    c2, front = chi2(cam, w, R, t, X)
    live = w.valid & front
    med = (torch.nanquantile(torch.where(live, c2, torch.full_like(
        c2, float("nan"))), 0.5) if bool(live.any())
        else torch.zeros((), dtype=c2.dtype, device=c2.device))
    gate = (c2 <= torch.maximum(GROSS[0] * w.th, GROSS[1] * med)) & front
    state, lam = _lm_phase(cam, w, (R, t, X), 1e-4, ITERS[0], True, gate,
                           dtype)
    c2, front = chi2(cam, w, *state)
    inliers = w.valid & front & (c2 <= w.th)
    state, _ = _lm_phase(cam, w, state, lam, ITERS[1], False, inliers,
                         dtype)
    return tuple(s.double() for s in state), inliers


def shortfall(cam, windows, control: bool = False):
    """Over the windows, the share of the reference's decrease of the
    truncated cost (from the start to the reference's result) that the
    candidate did not reach: the program's written-back result, or with
    `control` the reference's own BA in bfloat16. 0: as low a cost as the
    reference's on every window; 1: the start left unchanged. None where
    no window was captured."""
    if not windows:
        return None
    lost = gained = 0.0
    for w in windows:
        ref = local_ba(cam, w)[0]
        cand = local_ba(cam, w, torch.bfloat16)[0] if control else w.result
        c_ref = cost(cam, w, ref)
        gained += max(cost(cam, w, w.start) - c_ref, 0.0)
        lost += max(cost(cam, w, cand) - c_ref, 0.0)
    return lost / gained if gained > 0 else None


def match_rows(table: torch.Tensor, rows: torch.Tensor) -> np.ndarray:
    """For each row of `rows`, the index of a bit-equal row of `table`, or
    -1: where the program's window took each of its keyframes and
    landmarks from."""
    t = np.ascontiguousarray(table.detach().cpu().numpy())
    r = np.ascontiguousarray(rows.detach().cpu().numpy())
    index = {row.tobytes(): i for i, row in enumerate(t)}
    return np.array([index.get(row.tobytes(), -1) for row in r], np.int64)
