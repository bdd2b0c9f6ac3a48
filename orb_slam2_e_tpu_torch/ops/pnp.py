"""Perspective-n-Point: batched RANSAC for relocalization.

Port of `orb_slam2_e_tpu/ops/pnp.py` (the role of the reference's EPnP
PnPsolver with the E-extension's ranked pose hypotheses): every hypothesis
is solved at once, by the 6-point DLT (SVD of a (12, 12) system,
orthonormalised) and by a plane-basis homography decomposition for
coplanar samples, scored densely, ranked by inlier count, and the best is
refit on its whole inlier set.

RANSAC randomness: `ransac_pnp` draws its global minimal sets and its
anchors for the spatially local sets from a `torch.Generator`, sets first,
then anchors, as the reference splits its key; `sets=` and `anchors=` skip
the draws (the tests pass in the reference's).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .orb import top_k
from .twoview import gumbel


def _dlt_rows(xyz: torch.Tensor, uv_n: torch.Tensor) -> torch.Tensor:
    """(..., n, 3) points, (..., n, 2) normalised coords -> the (..., 2n,
    12) DLT system of P (3x4) row-major."""
    Xh = torch.cat([xyz, torch.ones_like(xyz[..., :1])], dim=-1)
    zeros = torch.zeros_like(Xh)
    rows_u = torch.cat([Xh, zeros, -uv_n[..., :1] * Xh], dim=-1)
    rows_v = torch.cat([zeros, Xh, -uv_n[..., 1:2] * Xh], dim=-1)
    return torch.cat([rows_u, rows_v], dim=-2)


def _sign(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x)[..., None, None]


def _pose_from_P(P: torch.Tensor):
    """A DLT solution P (..., 3, 4), defined up to scale and sign -> (R, t)
    with det(M) > 0, |det M| = 1 and M orthonormalised by SVD."""
    P = P * _sign(torch.linalg.det(P[..., :3]))
    M = P[..., :3]
    scale = torch.exp(torch.log(torch.clamp(
        torch.abs(torch.linalg.det(M)), min=1e-12)) / 3.0)
    t = P[..., 3] / scale[..., None]
    U, _, Vt = torch.linalg.svd(M / scale[..., None, None])
    R = U @ Vt
    return R * _sign(torch.linalg.det(R)), t


def pnp_dlt(xyz: torch.Tensor, uv_n: torch.Tensor):
    """DLT PnP from n >= 6 points (leading batch dims allowed): xyz (..., n,
    3) world points, uv_n (..., n, 2) normalised image coords. Returns
    (R (..., 3, 3), t (..., 3))."""
    A = _dlt_rows(xyz, uv_n)
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    return _pose_from_P(vt[..., 11, :].reshape(A.shape[:-2] + (3, 4)))


def pnp_planar(xyz: torch.Tensor, uv_n: torch.Tensor):
    """Pose from a (near-)planar sample through a plane-basis homography
    (IPPE-style); the DLT is degenerate there. Leading batch dims allowed.
    Returns world-to-camera (R (..., 3, 3), t (..., 3))."""
    c = xyz.mean(-2, keepdim=True)
    X0 = xyz - c
    # plane frame from the sample's principal axes: rows b1, b2 span the
    # plane, row 3 is the normal; right-handed
    _, _, Vt = torch.linalg.svd(X0, full_matrices=True)
    M = Vt * _sign(torch.linalg.det(Vt))
    q = X0 @ M.transpose(-1, -2)                       # q[..., 2] ~ 0
    qh = torch.cat([q[..., :2], torch.ones_like(q[..., :1])], dim=-1)
    zeros = torch.zeros_like(qh)
    A = torch.cat([torch.cat([qh, zeros, -uv_n[..., :1] * qh], -1),
                   torch.cat([zeros, qh, -uv_n[..., 1:2] * qh], -1)], -2)
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    H = vt[..., 8, :].reshape(A.shape[:-2] + (3, 3))
    h1, h2, h3 = H[..., 0], H[..., 1], H[..., 2]
    lam = 1.0 / torch.clamp(torch.sqrt(torch.linalg.norm(h1, dim=-1)
                                       * torch.linalg.norm(h2, dim=-1)),
                            min=1e-12)
    A12 = torch.stack([h1 * lam[..., None], h2 * lam[..., None]], -1)
    U2, _, V2t = torch.linalg.svd(A12, full_matrices=False)
    R12 = U2 @ V2t                                    # closest orthonormal
    a, b = R12[..., 0], R12[..., 1]
    r3 = torch.linalg.cross(a, b, dim=-1)
    tp = h3 * lam[..., None]
    c = c[..., 0, :]
    # two sign solutions (H ~ -H); keep the one with the sample in front
    Rw_a = torch.stack([a, b, r3], -1) @ M
    tw_a = tp - torch.einsum('...ij,...j->...i', Rw_a, c)
    Rw_b = torch.stack([-a, -b, r3], -1) @ M
    tw_b = -tp - torch.einsum('...ij,...j->...i', Rw_b, c)
    za = torch.einsum('...nj,...j->...n', xyz, Rw_a[..., 2, :]) \
        + tw_a[..., 2:3]
    flip = za.sum(-1) < 0
    R = torch.where(flip[..., None, None], Rw_b, Rw_a)
    t = torch.where(flip[..., None], tw_b, tw_a)
    return R, t


def pnp_dlt_weighted(xyz: torch.Tensor, uv_n: torch.Tensor,
                     w: torch.Tensor):
    """DLT refit over a weighted (masked) point set of any size, through
    the 12x12 normal matrix (eigh) instead of a (2n, 12) SVD (the role of
    the reference's post-RANSAC Refine)."""
    A = _dlt_rows(xyz, uv_n)
    G = (A * torch.cat([w, w])[:, None]).T @ A
    _, vecs = torch.linalg.eigh(G)                    # ascending
    return _pose_from_P(vecs[:, 0].reshape(3, 4))


class PnPResult(NamedTuple):
    R: torch.Tensor            # (B, 3, 3) hypothesis rotations, ranked
    t: torch.Tensor            # (B, 3)
    n_inliers: torch.Tensor    # (B,)
    inliers_best: torch.Tensor  # (N,) inlier mask of the best hypothesis


def _reproj_inliers(R, t, xyz, uv, valid, K, inlier_px):
    """Inlier masks (..., N) of poses R (..., 3, 3), t (..., 3)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xc = torch.einsum('...ij,nj->...ni', R, xyz) + t[..., None, :]
    z = xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = fx * xc[..., 0] / zs + cx
    v = fy * xc[..., 1] / zs + cy
    err2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
    return (err2 < inlier_px ** 2) & (z > 0) & valid


def ransac_pnp(gen, xyz: torch.Tensor, uv: torch.Tensor,
               valid: torch.Tensor, K: torch.Tensor, n_hyp: int = 256,
               sample_size: int = 6, inlier_px: float = 5.991 ** 0.5 * 2.0,
               local_frac: float = 0.5, sets=None,
               anchors=None) -> PnPResult:
    """Batched-hypothesis PnP RANSAC over xyz (N, 3), pixel uv (N, 2) and a
    valid (N,) mask. Half the hypotheses (`1 - local_frac`) use uniform
    random minimal sets; the rest use spatially local sets, a random anchor
    match and its nearest matched neighbours in the image, which stay
    usable under smooth deformation. Every sample yields a DLT pose and a
    planar pose; all are ranked by inlier count (stable, so ties keep the
    reference's order) and the best is refit on its inliers, kept if it
    scores at least as well.

    sets: (n_hyp - n_loc, sample_size) global sets; anchors: (n_loc,)."""
    dev = xyz.device
    uv_n = (torch.cat([uv, torch.ones_like(uv[:, :1])], 1)
            @ torch.linalg.inv(K).T)[:, :2]
    logits = torch.where(valid, 0.0, -1e9).to(torch.float32)
    n_loc = int(round(n_hyp * local_frac))
    N = valid.shape[0]
    if sets is None:
        g = gumbel(gen, (n_hyp - n_loc, N), dev) + logits[None]
        sets = top_k(g, sample_size)[1]
    if anchors is None:
        ga = gumbel(gen, (n_loc, N), dev) + logits[None]
        anchors = torch.argmax(ga, dim=1)             # first maximum
    anchors = anchors.long()
    d2 = ((uv[anchors][:, None, :] - uv[None, :, :]) ** 2).sum(-1)
    d2 = torch.where(valid[None, :], d2, torch.full_like(d2, float("inf")))
    sets_l = top_k(-d2, sample_size)[1]
    sets = torch.cat([sets.long(), sets_l])           # (B, 6)

    Rs_d, ts_d = pnp_dlt(xyz[sets], uv_n[sets])
    Rs_p, ts_p = pnp_planar(xyz[sets], uv_n[sets])
    Rs = torch.cat([Rs_d, Rs_p])                      # (2B, 3, 3)
    ts = torch.cat([ts_d, ts_p])
    inl = _reproj_inliers(Rs, ts, xyz, uv, valid, K, inlier_px)
    counts = inl.sum(1)
    order = torch.argsort(-counts, stable=True)
    best = order[0]

    Rr, tr = pnp_dlt_weighted(xyz, uv_n, inl[best].to(torch.float32))
    inl_r = _reproj_inliers(Rr, tr, xyz, uv, valid, K, inlier_px)
    cnt_r = inl_r.sum()
    take = cnt_r >= counts[best]
    R_out, t_out, cnt_out = Rs[order], ts[order], counts[order]
    R_out[0] = torch.where(take, Rr, R_out[0])
    t_out[0] = torch.where(take, tr, t_out[0])
    cnt_out[0] = torch.maximum(cnt_out[0], torch.where(take, cnt_r, 0))
    return PnPResult(R=R_out, t=t_out, n_inliers=cnt_out,
                     inliers_best=torch.where(take, inl_r, inl[best]))
