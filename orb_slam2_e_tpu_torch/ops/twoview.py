"""Two-view geometry: batched H/F RANSAC, model selection, reconstruction.

Port of `orb_slam2_e_tpu/ops/twoview.py` (reference Initializer.cc): every
RANSAC hypothesis is solved in one batch (normalized DLT through batched
SVDs) and scored densely, and all 12 candidate motions (4 from the
essential matrix, 8 from the homography) are triangulated and voted at once.
Also hosts the linear triangulation local mapping uses.

Where torch and JAX differ and the port chooses:
- RANSAC randomness: `jax.random` cannot be reproduced in torch. Sampling
  and solving are split: each RANSAC takes a `torch.Generator` and draws
  its minimal sets with the reference's Gumbel top-k construction, or takes
  the sets as `sets=` and skips the draw (the tests pass in the reference's
  sets). `initialize_two_view` draws H's sets, then F's, as the reference
  splits its key for H, then F.
- SVD sign and order: the DLT null vector and the U/V of the
  decompositions are defined up to sign. F and H matter only up to scale;
  the hypothesis sets are the same sets of motions, each possibly in
  another order or sign of its factors, and the vote picks the same motion.
  cuSOLVER on the card and LAPACK on the CPU may choose differently.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .orb import top_k

RANSAC_ITERS = 200       # reference Tracking.cc:698 (200 iterations)
SIGMA = 1.0              # reference Tracking.cc:698 (sigma = 1.0)
TH_F = 3.841             # chi2 95% 1-dof (reference CheckFundamental)
TH_H = 5.991             # chi2 95% 2-dof (reference CheckHomography)
TH_SCORE = 5.991         # score saturation


def triangulate_linear(P1: torch.Tensor, P2: torch.Tensor,
                       uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """Batched affine DLT triangulation: (3, 4) projections (leading batch
    dims allowed), (..., N, 2) pixels -> (..., N, 3) world points, solving
    M X = -q through the 3x3 normal equations as the reference does."""
    def rows(P, uv):
        return [uv[..., 0, None] * P[..., None, 2, :] - P[..., None, 0, :],
                uv[..., 1, None] * P[..., None, 2, :] - P[..., None, 1, :]]

    A = torch.stack(rows(P1, uv1) + rows(P2, uv2), dim=-2)   # (..., N, 4, 4)
    M = A[..., :3]
    q = A[..., 3]
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    MtM = torch.einsum('...ij,...ik->...jk', M, M) + 1e-9 * eye
    Mtq = torch.einsum('...ij,...i->...j', M, q)
    return -torch.linalg.solve_ex(MtM, Mtq[..., None])[0][..., 0]


def _normalize_points(uv: torch.Tensor, valid: torch.Tensor):
    """Hartley normalization: zero mean, unit mean absolute deviation.
    Returns (uvn, T)."""
    n = torch.clamp(valid.sum().to(uv.dtype), min=1.0)
    vm = valid[:, None]
    mean = torch.where(vm, uv, torch.zeros_like(uv)).sum(0) / n
    d = torch.where(vm, torch.abs(uv - mean), torch.zeros_like(uv))
    s = 1.0 / torch.clamp(d.sum(0) / n, min=1e-9)
    uvn = (uv - mean) * s
    z = torch.zeros_like(s[0])
    o = torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]),
                     torch.stack([z, z, o])])
    return uvn, T


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """Right singular vector of the smallest singular value of each
    (..., m, 9) system, as `svd(A, full_matrices=True)[2][8]`."""
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    return vt[..., A.shape[-1] - 1, :]


def _dlt_fundamental(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """8-point algorithm on (..., 8, 2) pairs -> F (..., 3, 3), rank 2."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)             # (..., 8, 9)
    F = _null_vector(A).reshape(A.shape[:-2] + (3, 3))
    u, s, v = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return u @ torch.diag_embed(s) @ v


def _dlt_homography(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """DLT on (..., 8, 2) pairs -> H (..., 3, 3) mapping p1 -> p2."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    A = torch.cat([r1, r2], dim=-2)                            # (..., 16, 9)
    return _null_vector(A).reshape(A.shape[:-2] + (3, 3))


def _homog(uv: torch.Tensor) -> torch.Tensor:
    return torch.cat([uv, torch.ones_like(uv[:, :1])], dim=1)


def _fundamental_score(F: torch.Tensor, uv1, uv2, valid, sigma: float):
    """Symmetric epipolar chi2 score (reference
    Initializer::CheckFundamental) of (..., 3, 3) hypotheses. Returns
    (score (...,), inlier (..., N))."""
    p1, p2 = _homog(uv1), _homog(uv2)
    Fp1 = p1 @ F.transpose(-1, -2)                  # lines in image 2
    Ftp2 = p2 @ F                                   # lines in image 1
    num = (p2 * Fp1).sum(-1)
    inv_sigma2 = 1.0 / sigma ** 2
    d2_2 = num ** 2 / torch.clamp(Fp1[..., 0] ** 2 + Fp1[..., 1] ** 2,
                                  min=1e-12) * inv_sigma2
    d2_1 = num ** 2 / torch.clamp(Ftp2[..., 0] ** 2 + Ftp2[..., 1] ** 2,
                                  min=1e-12) * inv_sigma2
    in1 = d2_1 < TH_F
    in2 = d2_2 < TH_F
    zero = torch.zeros_like(d2_1)
    score = (torch.where(valid & in1, TH_SCORE - d2_1, zero)
             + torch.where(valid & in2, TH_SCORE - d2_2, zero)).sum(-1)
    return score, valid & in1 & in2


def _homography_score(H: torch.Tensor, uv1, uv2, valid, sigma: float):
    """Symmetric transfer error score (reference
    Initializer::CheckHomography) of (..., 3, 3) hypotheses."""
    Hinv = torch.linalg.inv(H)
    p1, p2 = _homog(uv1), _homog(uv2)

    def transfer(Hm, a, b):
        q = a @ Hm.transpose(-1, -2)
        w = q[..., 2:3]
        w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
        return ((b - q[..., :2] / w) ** 2).sum(-1)

    inv_sigma2 = 1.0 / sigma ** 2
    d2_12 = transfer(H, p1, uv2) * inv_sigma2
    d2_21 = transfer(Hinv, p2, uv1) * inv_sigma2
    in12 = d2_12 < TH_H
    in21 = d2_21 < TH_H
    zero = torch.zeros_like(d2_12)
    score = (torch.where(valid & in12, TH_SCORE - d2_12, zero)
             + torch.where(valid & in21, TH_SCORE - d2_21, zero)).sum(-1)
    return score, valid & in12 & in21


def gumbel(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise from `gen` (the reference's
    `jax.random.gumbel`, with torch's uniform stream)."""
    u = torch.rand(shape, generator=gen, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def _sample_minimal_sets(gen: torch.Generator, valid: torch.Tensor,
                         n_sets: int, set_size: int = 8) -> torch.Tensor:
    """(n_sets, set_size) indices drawn among valid entries: Gumbel top-k
    per set gives distinct indices."""
    logits = torch.where(valid, 0.0, -1e9).to(torch.float32)
    g = gumbel(gen, (n_sets, valid.shape[0]), valid.device) + logits[None]
    return top_k(g, set_size)[1]


def _ransac(solve, score, gen, uv1, uv2, valid, sigma, n_iters, sets):
    """Solve every minimal set in the normalized frames with
    `solve(p1, p2, T1, T2)` -> (R, 3, 3) pixel-frame models, score all
    with `score`, keep the first best."""
    uvn1, T1 = _normalize_points(uv1, valid)
    uvn2, T2 = _normalize_points(uv2, valid)
    if sets is None:
        sets = _sample_minimal_sets(gen, valid, n_iters)
    sets = sets.long()
    Ms = solve(uvn1[sets], uvn2[sets], T1, T2)
    scores, inliers = score(Ms, uv1, uv2, valid, sigma)
    best = torch.argmax(scores)                              # first maximum
    return Ms[best], scores[best], inliers[best]


def ransac_fundamental(gen, uv1, uv2, valid, sigma: float = SIGMA,
                       n_iters: int = RANSAC_ITERS, sets=None):
    """Batched F RANSAC. Returns (F, score, inlier_mask). `sets`
    ((n_iters, 8) indices) skips the draw from `gen`."""
    return _ransac(lambda p1, p2, T1, T2: T2.T @ _dlt_fundamental(p1, p2)
                   @ T1, _fundamental_score, gen, uv1, uv2, valid, sigma,
                   n_iters, sets)


def ransac_homography(gen, uv1, uv2, valid, sigma: float = SIGMA,
                      n_iters: int = RANSAC_ITERS, sets=None):
    """Batched H RANSAC. Returns (H, score, inlier_mask)."""
    return _ransac(lambda p1, p2, T1, T2: torch.linalg.inv(T2)
                   @ _dlt_homography(p1, p2) @ T1, _homography_score, gen,
                   uv1, uv2, valid, sigma, n_iters, sets)


def decompose_essential(E: torch.Tensor):
    """E -> 4 motion hypotheses (R (4, 3, 3), t (4, 3) unit norm)
    (reference Initializer::DecomposeE)."""
    u, _, vt = torch.linalg.svd(E)
    u = u * torch.sign(torch.linalg.det(u))
    vt = vt * torch.sign(torch.linalg.det(vt))
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=E.dtype,
                     device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def decompose_homography(H: torch.Tensor, K: torch.Tensor):
    """Faugeras SVD decomposition of a calibrated homography -> 8
    hypotheses (R (8, 3, 3), t (8, 3), n (8, 3)) (reference
    Initializer::ReconstructH). Degenerate cases give hypotheses that lose
    the triangulation vote."""
    A = torch.linalg.inv(K) @ H @ K
    U, d, Vt = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    V = Vt.T
    eps = 1e-9
    dev, dt = H.device, H.dtype
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3),
                                  min=0.0))
    den13 = torch.clamp(d1 * d1 - d3 * d3, min=eps)
    x1_abs = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den13, min=0.0))
    x3_abs = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den13, min=0.0))
    e1 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=dt, device=dev)
    e3 = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=dt, device=dev)
    z4 = torch.zeros(4, dtype=dt, device=dev)
    o4 = torch.ones(4, dtype=dt, device=dev)

    def rot_y(c, s_, diag1, diag2, s_sign):
        # rows [[c, 0, s_sign * s], [0, diag1, 0], [s, 0, diag2]]
        return torch.stack([torch.stack([c * o4, z4, s_sign * s_], -1),
                            torch.stack([z4, diag1 * o4, z4], -1),
                            torch.stack([s_, z4, diag2 * o4], -1)], -2)

    # case d' = +d2
    sin_t = e1 * e3 * aux1 / torch.clamp((d1 + d3) * d2, min=eps)
    cos_t = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=eps)
    Rp_pos = rot_y(cos_t, sin_t, 1.0, cos_t, -1.0)
    tp_pos = (d1 - d3) * torch.stack([e1 * x1_abs, z4, -e3 * x3_abs], 1)
    np_pos = torch.stack([e1 * x1_abs, z4, e3 * x3_abs], 1)
    # case d' = -d2
    sin_p = e1 * e3 * aux1 / torch.clamp((d1 - d3) * d2, min=eps)
    cos_p = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=eps)
    Rp_neg = rot_y(cos_p, sin_p, -1.0, -cos_p, 1.0)
    tp_neg = (d1 + d3) * torch.stack([e1 * x1_abs, z4, e3 * x3_abs], 1)

    Rp = torch.cat([Rp_pos, Rp_neg])                          # (8, 3, 3)
    tp = torch.cat([tp_pos, tp_neg])
    npl = torch.cat([np_pos, np_pos])
    R = s * torch.einsum('ij,njk,kl->nil', U, Rp, Vt)
    t = torch.einsum('ij,nj->ni', U, tp)
    t = t / torch.clamp(torch.linalg.norm(t, dim=1, keepdim=True), min=eps)
    n = torch.einsum('ij,nj->ni', V, npl)
    return R, t, n


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)


def check_rt(R, t, uv1, uv2, valid, K: torch.Tensor, sigma: float = SIGMA):
    """Vote for motion hypotheses R (..., 3, 3), t (..., 3): triangulate
    every pair, keep those in front of both views with parallax and a
    reprojection chi2 < 4 sigma^2 (reference Initializer::CheckRT).

    Returns (n_good (...,), good (..., N), parallax_deg (...,),
    X (..., N, 3))."""
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    P1 = K @ torch.cat([eye, torch.zeros((3, 1), dtype=K.dtype,
                                         device=K.device)], 1)
    P2 = K @ torch.cat([R, t[..., None]], -1)
    P1 = P1.expand(P2.shape)
    X = triangulate_linear(P1, P2, uv1, uv2)                  # (..., N, 3)
    finite = torch.isfinite(X).all(-1)
    z1 = X[..., 2]
    Xc2 = X @ R.transpose(-1, -2) + t[..., None, :]
    z2 = Xc2[..., 2]
    O2 = -torch.einsum('...ji,...j->...i', R, t)
    r2 = X - O2[..., None, :]
    cosp = (X * r2).sum(-1) / torch.clamp(
        torch.linalg.norm(X, dim=-1) * torch.linalg.norm(r2, dim=-1),
        min=1e-12)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z1s, z2s = _safe_z(z1), _safe_z(z2)
    u1 = fx * X[..., 0] / z1s + cx
    v1 = fy * X[..., 1] / z1s + cy
    u2 = fx * Xc2[..., 0] / z2s + cx
    v2 = fy * Xc2[..., 1] / z2s + cy
    e1 = (u1 - uv1[:, 0]) ** 2 + (v1 - uv1[:, 1]) ** 2
    e2 = (u2 - uv2[:, 0]) ** 2 + (v2 - uv2[:, 1]) ** 2
    th2 = 4.0 * sigma ** 2
    good = (valid & finite & (z1 > 0) & (z2 > 0) & (cosp < 0.99998)
            & (e1 < th2) & (e2 < th2))
    n_good = good.sum(-1)
    # parallax of the good points: the 50th largest angle as the reference
    ang = torch.rad2deg(torch.arccos(torch.clamp(cosp, -1.0, 1.0)))
    ang_good = torch.where(good, ang, torch.zeros_like(ang))
    k = torch.clamp(torch.clamp(n_good, min=1), max=50) - 1
    ang_sorted = torch.sort(ang_good, dim=-1, descending=True).values
    parallax = torch.gather(ang_sorted, -1, k[..., None])[..., 0]
    return n_good, good, parallax, X


class InitResult(NamedTuple):
    success: torch.Tensor     # () bool
    R: torch.Tensor           # (3, 3) pose of frame 2 w.r.t. frame 1
    t: torch.Tensor           # (3,)
    points: torch.Tensor      # (N, 3) triangulated points, frame-1 coords
    good: torch.Tensor        # (N,) bool: triangulated and voted good
    used_homography: torch.Tensor


def initialize_two_view(gen, uv1, uv2, valid, K: torch.Tensor,
                        sigma: float = SIGMA, min_triangulated: int = 50,
                        min_parallax_deg: float = 1.0,
                        sets=None) -> InitResult:
    """Monocular bootstrap (reference Initializer::Initialize): H and F
    RANSAC, model choice by RH = SH / (SH + SF) > 0.40, decomposition, a
    vote of all 12 candidate motions by triangulation, and acceptance of a
    clear winner. `sets` = (sets_H, sets_F) skips both draws."""
    sets_h, sets_f = (None, None) if sets is None else sets
    H, sh, in_h = ransac_homography(gen, uv1, uv2, valid, sigma,
                                    sets=sets_h)
    F, sf, in_f = ransac_fundamental(gen, uv1, uv2, valid, sigma,
                                     sets=sets_f)
    rh = sh / torch.clamp(sh + sf, min=1e-12)
    use_h = rh > 0.40                                 # reference :120

    E = K.T @ F @ K
    Rs_e, ts_e = decompose_essential(E)
    Rs_h, ts_h, _ = decompose_homography(H, K)
    Rs = torch.cat([Rs_e, Rs_h])                      # (12, 3, 3)
    ts = torch.cat([ts_e, ts_h])
    model_mask = torch.cat([(~use_h).expand(4), use_h.expand(8)])
    vote_valid = valid & torch.where(use_h, in_h, in_f)

    n_good, good, parallax, X = check_rt(Rs, ts, uv1, uv2, vote_valid, K,
                                         sigma)
    n_good = torch.where(model_mask, n_good, -1)
    best = torch.argmax(n_good)                       # first maximum
    best_n = n_good[best]
    # clear winner: no other hypothesis within 75% of the best
    n_similar = (n_good > 0.75 * best_n).sum()
    n_valid = vote_valid.sum()
    success = ((best_n >= min_triangulated) & (best_n >= 0.5 * n_valid)
               & (n_similar == 1) & (parallax[best] > min_parallax_deg))
    return InitResult(success=success, R=Rs[best], t=ts[best],
                      points=X[best], good=good[best],
                      used_homography=use_h)
