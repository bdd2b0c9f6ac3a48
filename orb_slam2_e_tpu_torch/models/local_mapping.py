"""Local mapping: point culling, triangulation, fusion, landmark refresh,
local bundle adjustment and keyframe culling.

Port of `orb_slam2_e_tpu/models/local_mapping.py` (reference
LocalMapping.cc). Each stage is a function MapState -> MapState over the
same fixed capacities. Out-of-range scatter indices, which the reference
drops with `mode='drop'`, are routed to a spare slot and cut off; every
`jnp.nonzero(size=...)` is `scatter.nonzero_static`. The two keyframe-cull
rounds branch on the host (one sync each) instead of selecting between two
whole map states.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import lie, matching, twoview, ba, scatter
from ..ops.camera import Camera
from ..ops import camera as cam_ops
from ..ops.orb import top_k
from .frame import scale_invsigma2
from .map_state import MapState, INVALID

_I32 = torch.int32


class MappingConfig(NamedTuple):
    scale_factor: float = 1.2
    n_levels: int = 8
    n_neighbors: int = 10        # covisible KFs used for triangulation
    ba_cams: int = 16            # local BA free-camera window capacity
    ba_fixed: int = 16           # fixed-ring capacity
    ba_points: int = 4096        # local BA point capacity
    ba_obs: int = 12288          # local BA observation capacity
    ba_iters1: int = 3           # LM its before outlier reclassification
    ba_iters2: int = 4           # LM its after
    cull_min_found_ratio: float = 0.25
    cull_obs_th: int = 2


N_REFRESH_OBS = 8        # observations gathered per landmark in refresh
N_CULL_VICTIMS = 2       # keyframes cullable per mapping pass


def _scatter_into_2d(arr: torch.Tensor, rows, cols, ok, val, reduce=None):
    """arr[rows[ok], cols[ok]] = val[ok] (or amax-reduced), live rows only."""
    K, F = arr.shape
    flat = torch.cat([arr.reshape(-1), arr.new_zeros(1)])   # spare at K*F
    idx = torch.where(ok, rows.long() * F + cols.long(), K * F)
    val = torch.as_tensor(val, dtype=arr.dtype, device=arr.device).expand(
        idx.shape)
    if reduce is None:
        flat[idx] = val
    else:
        flat = flat.scatter_reduce(0, idx, val, reduce=reduce)
    return flat[:K * F].reshape(K, F)


def _fundamental_from_poses(R1, t1, R2, t2, K):
    """F12 between two cameras (reference LocalMapping::ComputeF12)."""
    R12 = R1 @ R2.T
    t12 = -R12 @ t2 + t1
    E = lie.so3_hat(t12) @ R12
    Kinv = torch.linalg.inv_ex(K)[0]
    return Kinv.T @ E @ Kinv


# ---------------------------------------------------------------------------
# Triangulate new landmarks against covisible neighbors
# ---------------------------------------------------------------------------

def triangulate_with_neighbors(cam: Camera, cfg: MappingConfig,
                               state: MapState, kf):
    """New landmarks by epipolar-constrained matching of the keyframe's
    unmatched features against its top covisible neighbours (reference
    LocalMapping::CreateNewMapPoints). Each feature keeps its best
    neighbour by descriptor distance; slots are allocated once."""
    dev = state.device
    K_mat = cam.K
    R1, t1 = lie.pose7_unpack(state.kf_pose7[kf])
    O1 = -R1.T @ t1
    covis = state.covisibility_row(kf)
    nb_w, nb_ids = top_k(covis, min(cfg.n_neighbors, covis.shape[0]))

    F = state.F
    f_uv = state.kf_kp_uvr[kf][:, :2]
    f_oct = state.kf_kp_octave[kf]
    f_ok = state.kf_kp_valid[kf] & (state.kf_kp_point[kf] < 0)
    bits1 = matching.unpack_desc(state.kf_desc[kf])
    inv_sig1 = scale_invsigma2(f_oct, cfg.scale_factor)
    P1 = K_mat @ torch.cat([R1, t1[:, None]], 1)
    ones = torch.ones((F, 1), device=dev)

    def per_neighbor(nb, w):
        ok_nb = (w > 10) & state.kf_valid[nb]
        R2, t2 = lie.pose7_unpack(state.kf_pose7[nb])
        O2 = -R2.T @ t2
        baseline = torch.linalg.norm(O2 - O1)
        pid2_all = state.kf_kp_point[nb]
        ok2_all = state.kf_kp_valid[nb] & (pid2_all >= 0)
        z2 = lie.se3_apply(R2, t2, state.lm_xyz[
            torch.where(ok2_all, pid2_all, 0).long()])[:, 2]
        med_depth = torch.sum(torch.where(ok2_all, z2, torch.zeros_like(z2))) \
            / torch.clamp(ok2_all.sum(), min=1)
        ok_nb = ok_nb & (baseline / torch.clamp(med_depth, min=1e-6) > 0.01)

        g_uv = state.kf_kp_uvr[nb][:, :2]
        g_oct = state.kf_kp_octave[nb]
        g_ok = state.kf_kp_valid[nb] & (state.kf_kp_point[nb] < 0)
        bits2 = matching.unpack_desc(state.kf_desc[nb])
        F12 = _fundamental_from_poses(R1, t1, R2, t2, K_mat)
        lines = torch.cat([f_uv, ones], dim=1) @ F12.T        # (F, 3)
        num = (lines[:, None, 0] * g_uv[None, :, 0]
               + lines[:, None, 1] * g_uv[None, :, 1] + lines[:, 2][:, None])
        den = torch.clamp(lines[:, 0] ** 2 + lines[:, 1] ** 2,
                          min=1e-12)[:, None]
        d2 = num * num / den
        sig2_2 = cfg.scale_factor ** (2.0 * g_oct.to(torch.float32))
        epi_ok = d2 < 3.84 * sig2_2[None, :]
        dmat = matching.hamming_matrix(bits1, bits2)
        mask = epi_ok & f_ok[:, None] & g_ok[None, :] & ok_nb
        bi, d1, _ = matching.masked_best2(dmat, mask)
        good = d1 <= matching.TH_LOW
        midx = matching.resolve_duplicates(
            torch.where(good, bi, INVALID), d1, F)
        pair_ok = midx >= 0
        safe = torch.where(pair_ok, midx, 0).long()
        P2 = K_mat @ torch.cat([R2, t2[:, None]], 1)
        X = twoview.triangulate_linear(P1, P2, f_uv, g_uv[safe])
        finite = torch.all(torch.isfinite(X), dim=1)
        xc1 = lie.se3_apply(R1, t1, X)
        xc2 = lie.se3_apply(R2, t2, X)
        zok = (xc1[:, 2] > 0) & (xc2[:, 2] > 0)
        r1v = X - O1
        r2v = X - O2
        d1n = torch.linalg.norm(r1v, dim=1)
        d2n = torch.linalg.norm(r2v, dim=1)
        cosp = torch.sum(r1v * r2v, 1) / torch.clamp(d1n * d2n, min=1e-9)
        par_ok = cosp < 0.9998
        uv1p, _ = cam_ops.project(cam, xc1)
        uv2p, _ = cam_ops.project(cam, xc2)
        e1 = torch.sum((uv1p - f_uv) ** 2, 1) * inv_sig1
        sig_inv2 = scale_invsigma2(g_oct[safe], cfg.scale_factor)
        e2 = torch.sum((uv2p - g_uv[safe]) ** 2, 1) * sig_inv2
        rp_ok = (e1 < 5.991) & (e2 < 5.991)
        ratio_d = d1n / torch.clamp(d2n, min=1e-9)
        ratio_o = cfg.scale_factor ** (f_oct - g_oct[safe]).to(torch.float32)
        sc_ok = (ratio_d < ratio_o * cfg.scale_factor * 1.5) \
            & (ratio_d > ratio_o / (cfg.scale_factor * 1.5))
        want = (pair_ok & finite & zok & par_ok & rp_ok & sc_ok & ok_nb
                & f_ok)
        dist1 = torch.linalg.norm(xc1, dim=1)
        maxd = dist1 * cfg.scale_factor ** f_oct.to(torch.float32)
        mind = maxd / cfg.scale_factor ** (cfg.n_levels - 1)
        normal = (r1v / torch.clamp(d1n[:, None], min=1e-9)
                  + r2v / torch.clamp(d2n[:, None], min=1e-9))
        normal = normal / torch.clamp(
            torch.linalg.norm(normal, dim=1, keepdim=True), min=1e-9)
        return want, d1, safe, X, mind, maxd, normal

    outs = [per_neighbor(nb_ids[i], nb_w[i]) for i in range(nb_ids.shape[0])]
    want_n, d1_n, g_n, X_n, mind_n, maxd_n, nrm_n = (
        torch.stack(list(x)) for x in zip(*outs))
    dsel = torch.where(want_n, d1_n.to(_I32), 1 << 20)
    best_nb = torch.argmin(dsel, dim=0)                     # (F,)
    far = torch.arange(F, device=dev)
    chosen = want_n[best_nb, far]
    X = X_n[best_nb, far]
    mind = mind_n[best_nb, far]
    maxd = maxd_n[best_nb, far]
    normal = nrm_n[best_nb, far]
    nb_sel = nb_ids[best_nb]
    g_sel = g_n[best_nb, far]

    slots, alloc_ok = state.allocate_points(chosen)
    okn = chosen & alloc_ok
    ms = scatter.masked_set
    kp_point = state.kf_kp_point.clone()
    kp_point[kf] = torch.where(okn, slots, kp_point[kf])
    kp_point = _scatter_into_2d(kp_point, nb_sel, g_sel, okn,
                                torch.where(okn, slots, INVALID),
                                reduce="amax")
    state = state._replace(
        lm_xyz=ms(state.lm_xyz, slots, okn, X),
        lm_valid=ms(state.lm_valid, slots, okn, True),
        lm_desc=ms(state.lm_desc, slots, okn, state.kf_desc[kf]),
        lm_angle=ms(state.lm_angle, slots, okn, state.kf_kp_angle[kf]),
        lm_normal=ms(state.lm_normal, slots, okn, normal),
        lm_min_dist=ms(state.lm_min_dist, slots, okn, mind),
        lm_max_dist=ms(state.lm_max_dist, slots, okn, maxd),
        lm_ref_kf=ms(state.lm_ref_kf, slots, okn, kf),
        lm_first_seq=ms(state.lm_first_seq, slots, okn, state.kf_seq[kf]),
        kf_kp_point=kp_point,
    )
    return state, okn.sum()


# ---------------------------------------------------------------------------
# Map point culling
# ---------------------------------------------------------------------------

def cull_map_points(cfg: MappingConfig, state: MapState, current_kf):
    """Remove low-quality recent landmarks (reference
    LocalMapping::MapPointCulling); age in keyframe sequence ids."""
    obs = state.observation_counts()
    ratio = state.lm_found / torch.clamp(state.lm_visible, min=1.0)
    age = state.kf_seq[current_kf] - state.lm_first_seq
    bad = state.lm_valid & (
        (ratio < cfg.cull_min_found_ratio)
        | ((age >= 2) & (obs <= cfg.cull_obs_th)))
    bad &= age <= 3
    return state.remove_points(bad), bad.sum()


# ---------------------------------------------------------------------------
# Fuse duplicates with neighbors
# ---------------------------------------------------------------------------

def _predict_octave(dist, max_dist, cfg):
    ratio = max_dist / torch.clamp(dist, min=1e-6)
    lvl = torch.ceil(torch.log(torch.clamp(ratio, min=1e-6))
                     / np.log(cfg.scale_factor)).to(_I32)
    return torch.clamp(lvl, 0, cfg.n_levels - 1)


def fuse_neighbors(cam: Camera, cfg: MappingConfig, state: MapState, kf):
    """Project neighbours' landmarks into `kf` and merge duplicates: the
    landmark with more observations absorbs the other (reference
    LocalMapping::SearchInNeighbors + ORBmatcher::Fuse)."""
    covis = state.covisibility_row(kf)
    nb_w, nb_ids = top_k(covis, min(cfg.n_neighbors, covis.shape[0]))
    sel = torch.zeros((state.K,), dtype=torch.bool, device=state.device)
    sel[nb_ids] = nb_w > 0                                  # distinct ids
    in_sel = sel[:, None] & state.kf_kp_valid & (state.kf_kp_point >= 0)
    lm_mask = scatter.mark(state.P, torch.where(
        in_sel, state.kf_kp_point, 0).reshape(-1), in_sel.reshape(-1))
    lm_mask &= state.lm_valid
    L = cfg.ba_points
    clipped = (lm_mask.sum() > L).to(_I32)
    ids, sub = scatter.nonzero_static(lm_mask, L)
    R, t = lie.pose7_unpack(state.kf_pose7[kf])
    xc = lie.se3_apply(R, t, state.lm_xyz[ids])
    uv, z = cam_ops.project(cam, xc)
    dist = torch.linalg.norm(xc, dim=1)
    ok = sub & (z > 0) & cam_ops.in_image(cam, uv) \
        & (dist >= 0.8 * state.lm_min_dist[ids]) \
        & (dist <= 1.2 * state.lm_max_dist[ids])
    oct_pred = _predict_octave(dist, state.lm_max_dist[ids], cfg)
    radius = 3.0 * cfg.scale_factor ** oct_pred.to(torch.float32)
    dmat = matching.hamming_matrix(matching.unpack_desc(state.lm_desc[ids]),
                                   matching.unpack_desc(state.kf_desc[kf]))
    mask = matching.window_mask(uv, state.kf_kp_uvr[kf][:, :2], radius)
    mask &= matching.octave_range_mask(oct_pred, state.kf_kp_octave[kf])
    mask &= ok[:, None] & state.kf_kp_valid[kf][None, :]
    best, d1, _ = matching.masked_best2(dmat, mask)
    good = d1 <= matching.TH_LOW
    midx = matching.resolve_duplicates(
        torch.where(good, best, INVALID), d1, state.F)
    obs = state.observation_counts()
    pair_ok = midx >= 0
    f_safe = torch.where(pair_ok, midx, 0).long()
    q = state.kf_kp_point[kf][f_safe]                       # current binding
    p = torch.where(pair_ok, ids, INVALID).to(_I32)         # projected lm
    # case A: feature unbound -> bind p
    bindA = pair_ok & (q < 0)
    kp_point = state.kf_kp_point.clone()
    kp_point[kf] = kp_point[kf].scatter_reduce(
        0, torch.where(bindA, f_safe, 0), torch.where(bindA, p, INVALID),
        reduce="amax")
    state = state._replace(kf_kp_point=kp_point)
    # case B: feature bound to q != p -> the weaker landmark is replaced by
    # the stronger one everywhere
    bindB = pair_ok & (q >= 0) & (q != p)
    p_obs = obs[torch.where(p >= 0, p, 0).long()]
    q_obs = obs[torch.where(q >= 0, q, 0).long()]
    loser = torch.where(bindB, torch.where(p_obs >= q_obs, q, p), INVALID)
    winner = torch.where(bindB, torch.where(p_obs >= q_obs, p, q), INVALID)
    pair_ok = (loser >= 0) & (winner >= 0)
    table = torch.arange(state.P, dtype=_I32, device=state.device)
    table = scatter.masked_set_last(table, loser, pair_ok, winner)
    pt = state.kf_kp_point
    remapped = torch.where(pt >= 0, table[torch.where(pt >= 0, pt, 0).long()],
                           pt)
    dead = scatter.mark(state.P, torch.where(pair_ok, loser, 0), pair_ok)
    loser_safe = torch.where(pair_ok, loser, 0).long()
    found_add = torch.zeros((state.P,), device=state.device).index_add_(
        0, torch.where(pair_ok, winner, 0).long(),
        pair_ok * state.lm_found[loser_safe])
    state = state._replace(
        kf_kp_point=remapped,
        lm_valid=state.lm_valid & ~dead,
        lm_found=state.lm_found + found_add,
    )
    return state, bindA.sum() + bindB.sum(), clipped


# ---------------------------------------------------------------------------
# MapPoint maintenance: distinctive descriptors + normal/depth refresh
# ---------------------------------------------------------------------------

def _popcount_u8(x: torch.Tensor) -> torch.Tensor:
    x = x.to(_I32)
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def refresh_landmarks(cfg: MappingConfig, state: MapState, kf):
    """Recompute each touched landmark's distinctive descriptor (least
    median Hamming distance to its other observations), its angle, viewing
    normal and scale-invariance distance bounds (reference
    MapPoint::ComputeDistinctiveDescriptors + UpdateNormalAndDepth).
    Touched = landmarks seen by `kf` or its top covisible neighbours."""
    K, F, P = state.K, state.F, state.P
    dev = state.device
    covis = state.covisibility_row(kf)
    nb_w, nb_ids = top_k(covis, min(cfg.n_neighbors, K))
    sel_kf = torch.zeros((K,), dtype=torch.bool, device=dev)
    sel_kf[nb_ids] = nb_w > 0
    sel_kf[kf] = True
    in_sel = sel_kf[:, None] & state.kf_kp_valid & (state.kf_kp_point >= 0)
    lm_mask = scatter.mark(P, torch.where(in_sel, state.kf_kp_point,
                                          0).reshape(-1), in_sel.reshape(-1))
    lm_mask &= state.lm_valid
    R_rows = cfg.ba_points
    pids, p_ok = scatter.nonzero_static(lm_mask, R_rows)

    # --- gather up to N_REFRESH_OBS (kf, feat) observations per landmark ---
    rows = torch.arange(R_rows, device=dev)
    p_row = scatter.scatter_min(P, torch.where(p_ok, pids, 0),
                                torch.where(p_ok, rows, R_rows), R_rows)
    pid_all = state.kf_kp_point
    ok_all = state.kf_kp_valid & (pid_all >= 0) & state.kf_valid[:, None]
    row_all = torch.where(ok_all, p_row[torch.where(pid_all >= 0, pid_all,
                                                    0).long()], R_rows)
    flat_row = row_all.reshape(-1)
    order = torch.argsort(flat_row, stable=True)
    sorted_rows = flat_row[order]
    seg_start = torch.searchsorted(sorted_rows, rows)
    rank = torch.arange(flat_row.shape[0], device=dev) - seg_start[
        torch.clamp(sorted_rows, 0, R_rows - 1)]
    dest_ok = (sorted_rows < R_rows) & (rank < N_REFRESH_OBS)
    kf_idx = (order // F).to(_I32)
    f_idx = (order % F).to(_I32)
    drow = torch.where(dest_ok, sorted_rows, R_rows)        # spare row
    drank = torch.where(dest_ok, rank, 0)
    obs_kf = torch.full((R_rows + 1, N_REFRESH_OBS), -1, dtype=_I32,
                        device=dev)
    obs_kf[drow, drank] = kf_idx
    obs_kf = obs_kf[:R_rows]
    obs_f = torch.zeros((R_rows + 1, N_REFRESH_OBS), dtype=_I32, device=dev)
    obs_f[drow, drank] = f_idx
    obs_f = obs_f[:R_rows].long()
    m = obs_kf >= 0
    kf_safe = torch.where(m, obs_kf, 0).long()

    # --- distinctive descriptor: min median pairwise Hamming ---
    d = state.kf_desc[kf_safe, obs_f]                       # (R, NOBS, 32)
    pop = _popcount_u8(d[:, :, None, :] ^ d[:, None, :, :]).sum(-1)
    pairmask = m[:, :, None] & m[:, None, :]
    BIG = 1 << 20
    pop = torch.where(pairmask, pop, BIG)
    pop_sorted = torch.sort(pop, dim=-1).values
    n_obs = m.sum(-1)
    med_idx = torch.clamp((n_obs - 1) // 2, 0, N_REFRESH_OBS - 1)
    med = torch.gather(pop_sorted, -1, med_idx[:, None, None].expand(
        -1, N_REFRESH_OBS, 1))[..., 0]
    med = torch.where(m, med, BIG)
    best = torch.argmin(med, dim=-1)
    new_desc = torch.gather(d, 1, best[:, None, None].expand(-1, 1, 32))[:, 0]

    # --- normal = mean unit viewing ray; depth bounds from obs 0 ---
    Rk, tk = lie.pose7_unpack(state.kf_pose7)
    Ow = -torch.einsum('kji,kj->ki', Rk, tk)
    X = state.lm_xyz[pids]
    rays = X[:, None, :] - Ow[kf_safe]
    rays = rays / torch.clamp(torch.linalg.norm(rays, dim=-1, keepdim=True),
                              min=1e-9)
    normal = torch.sum(torch.where(m[..., None], rays,
                                   torch.zeros_like(rays)), dim=1)
    normal = normal / torch.clamp(
        torch.linalg.norm(normal, dim=-1, keepdim=True), min=1e-9)
    ref_kf = obs_kf[:, 0]
    ref_ok = ref_kf >= 0
    ref_safe = torch.where(ref_ok, ref_kf, 0).long()
    dist = torch.linalg.norm(X - Ow[ref_safe], dim=-1)
    ref_oct = state.kf_kp_octave[ref_safe, obs_f[:, 0]]
    maxd = dist * cfg.scale_factor ** ref_oct.to(torch.float32)
    mind = maxd / cfg.scale_factor ** (cfg.n_levels - 1)
    new_angle = torch.gather(state.kf_kp_angle[kf_safe, obs_f], 1,
                             best[:, None])[:, 0]
    upd = p_ok & (n_obs >= 2) & ref_ok
    ms = scatter.masked_set
    return state._replace(
        lm_desc=ms(state.lm_desc, pids, upd, new_desc),
        lm_angle=ms(state.lm_angle, pids, upd, new_angle),
        lm_normal=ms(state.lm_normal, pids, upd, normal),
        lm_max_dist=ms(state.lm_max_dist, pids, upd, maxd),
        lm_min_dist=ms(state.lm_min_dist, pids, upd, mind),
    )


# ---------------------------------------------------------------------------
# Local bundle adjustment window extraction + solve
# ---------------------------------------------------------------------------

def local_ba(cam: Camera, cfg: MappingConfig, state: MapState, kf):
    """Local BA around `kf` (reference Optimizer::LocalBundleAdjustment):
    free cameras = kf + covisible (>= 15 shared), free points = their
    landmarks, fixed ring = other keyframes observing those points; slot 0
    always fixed (gauge). Returns (state, final_cost, clip bits)."""
    dev = state.device
    K, F, P = state.K, state.F, state.P
    covis = state.covisibility_row(kf)
    free_w, free_ids = top_k(covis, min(cfg.ba_cams - 1, covis.shape[0]))
    free_mask = torch.zeros((K,), dtype=torch.bool, device=dev)
    free_mask[free_ids] = free_w >= 15
    free_mask[kf] = True
    in_free = free_mask[:, None] & state.kf_kp_valid & (state.kf_kp_point >= 0)
    lm_mask = scatter.mark(P, torch.where(in_free, state.kf_kp_point,
                                          0).reshape(-1), in_free.reshape(-1))
    lm_mask &= state.lm_valid
    clip_pts = (lm_mask.sum() > cfg.ba_points).to(_I32)
    pids, p_ok = scatter.nonzero_static(lm_mask, cfg.ba_points)
    sees_local = scatter.mark(P, pids, p_ok)
    pt = state.kf_kp_point
    kf_sees = torch.any(
        sees_local[torch.where(pt >= 0, pt, 0).long()] & (pt >= 0)
        & state.kf_kp_valid, dim=1)
    fixed_mask = kf_sees & state.kf_valid & ~free_mask
    clip_fix = (fixed_mask.sum() > cfg.ba_fixed).to(_I32)
    fixed_ids, fix_ok = scatter.nonzero_static(fixed_mask, cfg.ba_fixed)
    free_idsc, free_ok = scatter.nonzero_static(free_mask, cfg.ba_cams)

    cam_ids = torch.cat([free_idsc, fixed_ids])
    cam_ok = torch.cat([free_ok, fix_ok])
    cam_free = torch.cat([free_ok, torch.zeros_like(fix_ok)]) & (cam_ids != 0)

    p_row = scatter.scatter_max(
        P, torch.where(p_ok, pids, 0),
        torch.where(p_ok, torch.arange(cfg.ba_points, dtype=_I32,
                                       device=dev), INVALID), INVALID)
    kp_pt = state.kf_kp_point[cam_ids]                      # (C, F)
    kp_ok = state.kf_kp_valid[cam_ids] & (kp_pt >= 0) & cam_ok[:, None]
    prow = p_row[torch.where(kp_pt >= 0, kp_pt, 0).long()]
    flat_ok = (kp_ok & (prow >= 0)).reshape(-1)
    clip_obs = (flat_ok.sum() > cfg.ba_obs).to(_I32)
    o_sel, o_live = scatter.nonzero_static(flat_ok, cfg.ba_obs)
    o_cam = o_sel // F
    o_feat = o_sel % F
    o_point = prow.reshape(-1)[o_sel]
    uvr = state.kf_kp_uvr[cam_ids].reshape(-1, 3)[o_sel]
    octv = state.kf_kp_octave[cam_ids].reshape(-1)[o_sel]
    prob = ba.BAProblem(
        cam_pose7=state.kf_pose7[cam_ids], cam_free=cam_free,
        points=state.lm_xyz[pids], point_valid=p_ok,
        obs_cam=o_cam, obs_point=torch.where(o_live, o_point, 0),
        obs_uvr=uvr, obs_inv_sigma2=scale_invsigma2(octv, cfg.scale_factor),
        obs_valid=o_live)
    res = ba.ba_solve(cam, prob, iters_phase1=cfg.ba_iters1,
                      iters_phase2=cfg.ba_iters2)
    new_pose = scatter.masked_set(state.kf_pose7, cam_ids, cam_ok & cam_free,
                                  res.cam_pose7)
    new_xyz = scatter.masked_set(state.lm_xyz, pids, p_ok, res.points)
    out = o_live & ~res.obs_inlier
    kp_point = _scatter_into_2d(state.kf_kp_point, cam_ids[o_cam], o_feat,
                                out, INVALID)
    state = state._replace(kf_pose7=new_pose, lm_xyz=new_xyz,
                           kf_kp_point=kp_point)
    clipped = clip_pts | (clip_fix << 1) | (clip_obs << 2)
    return state, res.final_cost, clipped


# ---------------------------------------------------------------------------
# The mapping pass + keyframe culling
# ---------------------------------------------------------------------------

def mapping_pass(cam: Camera, cfg: MappingConfig, state: MapState, kf,
                 do_ba: bool = True, do_cull_kf: bool = True):
    """Point culling -> triangulation -> fusion -> landmark refresh ->
    local BA -> keyframe culling for one new keyframe (reference
    LocalMapping::Run body). Returns (state, (n_culled, n_new,
    victims (N_CULL_VICTIMS,), clip_bits))."""
    state, n_culled = cull_map_points(cfg, state, kf)
    state, n_new = triangulate_with_neighbors(cam, cfg, state, kf)
    state, _, clip_fuse = fuse_neighbors(cam, cfg, state, kf)
    state = refresh_landmarks(cfg, state, kf)
    clipped = clip_fuse << 3
    if do_ba:
        state, _, clip_ba = local_ba(cam, cfg, state, kf)
        clipped = clipped | clip_ba
    victims = torch.full((N_CULL_VICTIMS,), INVALID, dtype=_I32,
                         device=state.device)
    if do_cull_kf:
        state, victims = cull_keyframes(cfg, state, kf)
    return state, (n_culled, n_new, victims, clipped)


def mapping_pass_dyn(cam: Camera, cfg: MappingConfig, state: MapState, kf,
                     do_ba: torch.Tensor, do_cull_kf: torch.Tensor):
    """`mapping_pass` with `do_ba` / `do_cull_kf` as 0-d bool tensors (the
    reference's `lax.cond`s inside its fused frame step). Eager PyTorch
    cannot skip a launch on a predicate that stays on the device, so their
    values are read on the host: free for CPU tensors, as the pipelined
    super-step passes them (part of its one predicate read), one
    synchronization each for tensors on the card."""
    return mapping_pass(cam, cfg, state, kf, do_ba=bool(do_ba),
                        do_cull_kf=bool(do_cull_kf))


def cull_keyframes(cfg: MappingConfig, state: MapState, kf):
    """Cull covisible keyframes whose landmarks are >= 90% redundant (seen
    by >= 3 other keyframes at the same or finer scale; reference
    LocalMapping::KeyFrameCulling). N_CULL_VICTIMS sequential rounds with
    refreshed counts; slot 0 and `kf` are kept. Returns (state, victims
    (N_CULL_VICTIMS,) int32, INVALID-padded)."""
    n_levels = cfg.n_levels
    victims = []
    for _ in range(N_CULL_VICTIMS):
        covis = state.covisibility_row(kf)
        cand_mask = (covis > 0) & state.kf_valid
        cand_mask[0] = False
        cand_mask[kf] = False
        pt = state.kf_kp_point
        okf = state.kf_kp_valid & (pt >= 0) & state.kf_valid[:, None]
        pt_safe = torch.where(okf, pt, 0).long()
        oc = torch.clamp(state.kf_kp_octave, 0, n_levels - 1).long()
        cnt = torch.zeros((state.P * n_levels,), dtype=_I32,
                          device=state.device).scatter_add(
            0, (pt_safe * n_levels + oc).reshape(-1),
            okf.to(_I32).reshape(-1)).reshape(state.P, n_levels)
        cum = torch.cumsum(cnt, dim=1)
        o1 = torch.clamp(oc + 1, 0, n_levels - 1)
        n_fine_other = cum[pt_safe, o1] - 1
        redundant = okf & (n_fine_other >= 3)
        n_pts = okf.sum(1)
        ratio = redundant.sum(1) / torch.clamp(n_pts, min=1)
        score = torch.where(cand_mask & (n_pts > 0), ratio.to(torch.float32),
                            torch.zeros_like(ratio, dtype=torch.float32))
        victim = int(torch.argmax(score))
        if not bool(score[victim] > 0.9):
            victims.append(INVALID)
            continue
        vic_parent = state.kf_parent[victim]
        new_state = state.remove_keyframe(victim)
        state = new_state._replace(kf_parent=torch.where(
            (state.kf_parent == victim) & state.kf_valid, vic_parent,
            new_state.kf_parent))
        victims.append(victim)
    return state, torch.tensor(victims, dtype=_I32, device=state.device)
