"""Per-frame tracking: motion-model search, reference-keyframe fallback,
local-map tracking, pose optimization, the localization-only step with
temporary visual-odometry points, keyframe insertion and the monocular
two-view initialization.

Port of `orb_slam2_e_tpu/models/tracking.py` (reference Tracking.cc).
Searches are dense masked Hamming matrices (`ops/matching.py`).
`track_frame_fused` and `track_frame_loc` keep the reference's structure:
both the motion-model and the reference-keyframe stage are computed and the
outcome is selected with `torch.where`, so the step never waits on the
device; the host reads the packed flags once per frame.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import lie, matching, pose_opt, scatter, twoview
from ..ops.ba import _nanmedian_mid
from ..ops.camera import Camera
from ..ops import camera as cam_ops
from ..ops.orb import top_k
from .frame import Frame, compact_frame, scale_invsigma2
from .map_state import MapState, INVALID

_I32 = torch.int32


class TrackConfig(NamedTuple):
    scale_factor: float = 1.2
    n_levels: int = 8
    local_points_cap: int = 4096
    local_kf_cap: int = 80
    min_inliers_motion: int = 10
    min_inliers_map: int = 30
    radius_motion: float = 15.0
    radius_map: float = 4.0
    th_depth: float = 35.0
    min_close_spawn: int = 100


def _select(cond, a: Frame, b: Frame) -> Frame:
    """Field-wise torch.where over two Frames (jax.tree.map of where)."""
    return Frame(*(torch.where(cond, x, y) for x, y in zip(a, b)))


# ---------------------------------------------------------------------------
# Projection-guided matching against a landmark subset
# ---------------------------------------------------------------------------

def predict_scale(dist, max_dist, scale_factor: float, n_levels: int):
    """Scale level a landmark should appear at (MapPoint::PredictScale)."""
    ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-6), min=1e-6)
    lvl = torch.ceil(torch.log(ratio) / np.log(scale_factor)).to(_I32)
    return torch.clamp(lvl, 0, n_levels - 1)


def search_landmarks_projected(
        cam: Camera, cfg: TrackConfig, R, t,
        lm_xyz, lm_desc, lm_mask, lm_maxdist, lm_mindist, lm_normal,
        frame: Frame, radius_scale: float, max_hamming: int,
        ratio: float = 0.8, pred_octave=None, check_view_cos: bool = True,
        angles=None):
    """Project a landmark subset and match it to the frame's features
    (reference ORBmatcher::SearchByProjection). Returns
    (lm_best_feature (L,), dists (L,), proj_ok (L,))."""
    xc = lie.se3_apply(R, t, lm_xyz)
    uv, z = cam_ops.project(cam, xc)
    in_img = cam_ops.in_image(cam, uv) & (z > 0)
    dist = torch.linalg.norm(xc, dim=-1)
    in_dist = (dist >= 0.8 * lm_mindist) & (dist <= 1.2 * lm_maxdist)
    ok = lm_mask & in_img & in_dist
    if check_view_cos:
        Ow = -torch.einsum('ji,j->i', R, t)
        po = lm_xyz - Ow
        pn = po / torch.clamp(torch.linalg.norm(po, dim=-1, keepdim=True),
                              min=1e-9)
        ok &= torch.sum(pn * lm_normal, dim=-1) > 0.5
    if pred_octave is None:
        oct_pred = predict_scale(dist, lm_maxdist, cfg.scale_factor,
                                 cfg.n_levels)
    else:
        oct_pred = pred_octave
    radius = radius_scale * cfg.scale_factor ** oct_pred.to(torch.float32)

    dmat = matching.hamming_matrix(matching.unpack_desc(lm_desc),
                                   matching.unpack_desc(frame.desc))
    mask = matching.window_mask(uv, frame.uvr[:, :2], radius)
    mask &= matching.octave_range_mask(oct_pred, frame.octave)
    mask &= ok[:, None] & frame.valid[None, :]
    mask &= frame.point_ids[None, :] < 0     # don't steal bound features
    best_idx, d1, d2 = matching.masked_best2(dmat, mask)
    good = (d1 <= max_hamming) & (d1.to(torch.float32)
                                  < ratio * d2.to(torch.float32))
    if angles is not None:
        ang_f = frame.angle[torch.clamp(best_idx, 0, frame.F - 1)]
        good = matching.rotation_consistency_mask(angles, ang_f, good)
    return torch.where(good, best_idx, INVALID), d1, ok


def bind_matches(frame: Frame, lm_ids, lm_best_feature, dists):
    """Write landmark->feature matches into frame.point_ids; a feature
    claimed twice goes to the lowest Hamming distance, then the lowest
    landmark row."""
    L = lm_ids.shape[0]
    F = frame.F
    dev = frame.uvr.device
    hit = lm_best_feature >= 0
    feat = torch.where(hit, lm_best_feature, F)              # F = dump slot
    dists = dists.to(_I32)
    best_d = scatter.scatter_min(
        F + 1, feat, torch.where(hit, dists, matching.BIG), matching.BIG)
    win = hit & (dists <= best_d[feat.long()])
    lrow = torch.arange(L, device=dev)
    first = scatter.scatter_min(F + 1, feat, torch.where(win, lrow, L), L)
    win &= first[feat.long()] == lrow
    new_ids = scatter.scatter_max(
        F + 1, feat, torch.where(win, lm_ids, INVALID).to(_I32),
        INVALID)[:F]
    return frame._replace(point_ids=torch.where(new_ids >= 0, new_ids,
                                                frame.point_ids))


# ---------------------------------------------------------------------------
# Pose optimization on current frame matches
# ---------------------------------------------------------------------------

def optimize_frame_pose(cam: Camera, cfg: TrackConfig, state: MapState,
                        frame: Frame):
    """Motion-only LM on the frame's bound landmarks; outliers are
    unbound. Returns (frame, n_inliers)."""
    pid = frame.point_ids
    okp = (pid >= 0) & frame.valid
    safe = torch.where(okp, pid, 0).long()
    okp &= state.lm_valid[safe]
    obs = pose_opt.PoseObs(
        uvr=frame.uvr, xyz=state.lm_xyz[safe],
        inv_sigma2=scale_invsigma2(frame.octave, cfg.scale_factor),
        valid=okp)
    R0, t0 = lie.pose7_unpack(frame.pose7)
    R, t, inlier, n_in = pose_opt.pose_optimize(cam, R0, t0, obs)
    new_pid = torch.where(okp & ~inlier, INVALID, pid)
    return frame._replace(pose7=lie.pose7_pack(R, t), point_ids=new_pid), n_in


# ---------------------------------------------------------------------------
# Tracking stages
# ---------------------------------------------------------------------------

def track_motion_model(cam: Camera, cfg: TrackConfig, state: MapState,
                       frame: Frame, last_frame: Frame, pose7_pred):
    """Match the last frame's landmarks around the motion-model prediction,
    then optimize (reference Tracking::TrackWithMotionModel)."""
    R, t = lie.pose7_unpack(pose7_pred)
    lm_ids = torch.where(last_frame.valid, last_frame.point_ids, INVALID)
    safe = torch.where(lm_ids >= 0, lm_ids, 0).long()
    lm_mask = (lm_ids >= 0) & state.lm_valid[safe]
    best_feat, dists, _ = search_landmarks_projected(
        cam, cfg, R, t,
        state.lm_xyz[safe], state.lm_desc[safe], lm_mask,
        # distance bounds disabled for the last-frame search
        torch.full(safe.shape, 1e9, device=safe.device),
        torch.zeros(safe.shape, device=safe.device), state.lm_normal[safe],
        frame, radius_scale=cfg.radius_motion, max_hamming=matching.TH_HIGH,
        ratio=0.9, pred_octave=last_frame.octave, check_view_cos=False,
        angles=last_frame.angle)
    frame = frame._replace(pose7=pose7_pred)
    frame = bind_matches(frame, lm_ids, best_feat, dists)
    n_matches = (frame.point_ids >= 0).sum()
    frame, n_in = optimize_frame_pose(cam, cfg, state, frame)
    return frame, n_matches, n_in


def track_reference_keyframe(cam: Camera, cfg: TrackConfig, state: MapState,
                             frame: Frame, ref_kf, pose7_init):
    """Match the reference keyframe's landmarks by descriptor alone and
    optimize (reference Tracking::TrackReferenceKeyFrame)."""
    kp_pid = state.kf_kp_point[ref_kf]
    kp_ok = state.kf_kp_valid[ref_kf] & (kp_pid >= 0)
    safe = torch.where(kp_ok, kp_pid, 0).long()
    kp_ok &= state.lm_valid[safe]
    dmat = matching.hamming_matrix(
        matching.unpack_desc(state.kf_desc[ref_kf]),
        matching.unpack_desc(frame.desc))
    mask = kp_ok[:, None] & frame.valid[None, :]
    best_idx, d1, d2 = matching.masked_best2(dmat, mask)
    good = (d1 <= matching.TH_LOW) & (d1.to(torch.float32)
                                      < 0.7 * d2.to(torch.float32))
    good = matching.rotation_consistency_mask(
        state.kf_kp_angle[ref_kf],
        frame.angle[torch.clamp(best_idx, 0, frame.F - 1)], good)
    frame = frame._replace(pose7=pose7_init)
    frame = bind_matches(frame, torch.where(kp_ok, kp_pid, INVALID),
                         torch.where(good, best_idx, INVALID),
                         torch.where(good, d1, matching.BIG))
    n_matches = (frame.point_ids >= 0).sum()
    frame, n_in = optimize_frame_pose(cam, cfg, state, frame)
    return frame, n_matches, n_in


def track_local_map(cam: Camera, cfg: TrackConfig, state: MapState,
                    frame: Frame):
    """Local map = keyframes voted by current matches + their points;
    project, match, optimize (reference Tracking::TrackLocalMap).
    Returns (frame, n_inliers, visible (P,), found (P,), clipped)."""
    dev = state.device
    pid = frame.point_ids
    okp = (pid >= 0) & frame.valid
    marker = scatter.scatter_max(state.P, torch.where(okp, pid, 0),
                                 okp.to(_I32), 0)
    kf_pt = torch.where(state.kf_kp_valid, state.kf_kp_point, 0).long()
    kf_hit = marker[kf_pt] * (state.kf_kp_point >= 0) * state.kf_kp_valid
    votes = (kf_hit.sum(1) * state.kf_valid).to(_I32)        # (K,)
    k_cap = min(cfg.local_kf_cap, int(votes.shape[0]))
    top_votes, top_kfs = top_k(votes, k_cap)
    local_kf_mask = torch.zeros((state.K,), dtype=torch.bool, device=dev)
    local_kf_mask[top_kfs] = top_votes > 0                  # distinct ids
    in_local = (local_kf_mask[:, None] & state.kf_kp_valid
                & (state.kf_kp_point >= 0))
    lm_local = scatter.mark(state.P, torch.where(
        in_local, state.kf_kp_point, 0).reshape(-1), in_local.reshape(-1))
    lm_local &= state.lm_valid
    lm_local &= ~(marker > 0)        # skip points matched already
    L = cfg.local_points_cap
    clipped = (lm_local.sum() > L).to(_I32)
    ids, sub_mask = scatter.nonzero_static(lm_local, L)
    R, t = lie.pose7_unpack(frame.pose7)
    best_feat, dists, proj_ok = search_landmarks_projected(
        cam, cfg, R, t,
        state.lm_xyz[ids], state.lm_desc[ids], sub_mask,
        state.lm_max_dist[ids], state.lm_min_dist[ids], state.lm_normal[ids],
        frame, radius_scale=cfg.radius_map, max_hamming=matching.TH_HIGH,
        ratio=0.8)
    frame = bind_matches(frame, torch.where(sub_mask, ids, INVALID),
                         best_feat, dists)
    frame, n_in = optimize_frame_pose(cam, cfg, state, frame)
    visible = scatter.mark(state.P, ids, sub_mask & proj_ok) | (marker > 0)
    fin = (frame.point_ids >= 0) & frame.valid
    found = scatter.mark(state.P, torch.where(fin, frame.point_ids, 0), fin)
    return frame, n_in, visible, found, clipped


def update_visibility_counters(state: MapState, visible, found):
    return state._replace(
        lm_visible=state.lm_visible + visible.to(state.lm_visible.dtype),
        lm_found=state.lm_found + found.to(state.lm_found.dtype))


def track_frame_fused(cam: Camera, cfg: TrackConfig, state: MapState,
                      frame: Frame, last_frame: Frame, velocity7,
                      have_velocity: bool, ref_kf):
    """Motion-model attempt, reference-keyframe fallback, local-map
    tracking, visibility counters, keyframe-policy statistic and the
    next-frame velocity. Returns (state, frame, velocity7', flags) with
    flags = [ok, n_inliers, ref_matches, clipped] int32 (one host read)."""
    pred7, Rl, tl = _predict_pose7(last_frame, velocity7, have_velocity)

    f_mm, _, n_in_mm = track_motion_model(cam, cfg, state, frame,
                                          last_frame, pred7)
    mm_ok = have_velocity & (n_in_mm >= cfg.min_inliers_motion)
    f_rf, _, n_in_rf = track_reference_keyframe(cam, cfg, state, frame,
                                                ref_kf, last_frame.pose7)
    f1 = _select(mm_ok, f_mm, f_rf)
    stage1_ok = mm_ok | (n_in_rf >= cfg.min_inliers_motion)

    f2, n_in, visible, found, clipped = track_local_map(cam, cfg, state, f1)
    state = update_visibility_counters(state, visible & stage1_ok,
                                       found & stage1_ok)
    ok = stage1_ok & (n_in >= cfg.min_inliers_map)
    frame_out = _select(stage1_ok, f2, frame)
    ref_matches = ((state.kf_kp_point[ref_kf] >= 0)
                   & state.kf_kp_valid[ref_kf]).sum()
    R_c, t_c = lie.pose7_unpack(frame_out.pose7)
    R_li, t_li = lie.se3_inverse(Rl, tl)
    vel_new = lie.pose7_pack(*lie.se3_compose(R_c, t_c, R_li, t_li))
    flags = torch.stack([ok.to(_I32),
                         torch.where(stage1_ok, n_in, 0).to(_I32),
                         ref_matches.to(_I32), clipped])
    return state, frame_out, vel_new, flags


def _predict_pose7(last_frame: Frame, velocity7, have_velocity: bool):
    """Motion-model prediction velocity * last pose; the last pose itself
    without a velocity. Returns (pred7, Rl, tl)."""
    Rl, tl = lie.pose7_unpack(last_frame.pose7)
    if not have_velocity:
        return last_frame.pose7, Rl, tl
    Rv, tv = lie.pose7_unpack(velocity7)
    return lie.pose7_pack(*lie.se3_compose(Rv, tv, Rl, tl)), Rl, tl


# ---------------------------------------------------------------------------
# Localization-only mode with visual-odometry points (reference mbVO)
# ---------------------------------------------------------------------------

def track_motion_model_vo(cam: Camera, cfg: TrackConfig, state: MapState,
                          frame: Frame, last_frame: Frame, pose7_pred):
    """Motion-model tracking with temporary "visual odometry" points: the
    last frame's features that carry depth but no landmark are unprojected
    and matched frame to frame, so tracking survives where the camera
    leaves the mapped region (reference UpdateLastFrame in localization
    mode, Tracking.cc:1160-1222; TrackWithMotionModel then sets mbVO =
    nmatchesMap < 10). The points never enter the map.

    Returns (frame, n_map_inliers, n_total_inliers)."""
    dev = state.device
    R, t = lie.pose7_unpack(pose7_pred)
    # landmark matches: the search of track_motion_model, no rotation check
    lm_ids = torch.where(last_frame.valid, last_frame.point_ids, INVALID)
    safe = torch.where(lm_ids >= 0, lm_ids, 0).long()
    lm_mask = (lm_ids >= 0) & state.lm_valid[safe]
    best_feat, dists, _ = search_landmarks_projected(
        cam, cfg, R, t,
        state.lm_xyz[safe], state.lm_desc[safe], lm_mask,
        torch.full(safe.shape, 1e9, device=dev),
        torch.zeros(safe.shape, device=dev), state.lm_normal[safe], frame,
        radius_scale=cfg.radius_motion, max_hamming=matching.TH_HIGH,
        ratio=0.9, pred_octave=last_frame.octave, check_view_cos=False)
    frame = frame._replace(pose7=pose7_pred)
    frame = bind_matches(frame, lm_ids, best_feat, dists)

    # temporary VO points from the last frame's depth
    Rl, tl = lie.pose7_unpack(last_frame.pose7)
    Rwl, twl = lie.se3_inverse(Rl, tl)
    vo_src = (last_frame.valid & (last_frame.depth > 0)
              & (last_frame.point_ids < 0))
    vo_xyz = lie.se3_apply(Rwl, twl, cam_ops.backproject(
        cam, last_frame.uvr[:, :2], last_frame.depth))
    uv, z = cam_ops.project(cam, lie.se3_apply(R, t, vo_xyz))
    proj_ok = vo_src & cam_ops.in_image(cam, uv) & (z > 0)
    sigma = cfg.scale_factor ** last_frame.octave.to(torch.float32)
    dmat = matching.hamming_matrix(matching.unpack_desc(last_frame.desc),
                                   matching.unpack_desc(frame.desc))
    mask = matching.window_mask(uv, frame.uvr[:, :2],
                                cfg.radius_motion * sigma)
    mask &= matching.octave_range_mask(last_frame.octave, frame.octave)
    mask &= proj_ok[:, None] & frame.valid[None, :]
    mask &= frame.point_ids[None, :] < 0     # landmark matches come first
    vo_feat, d1, d2 = matching.masked_best2(dmat, mask)
    vo_good = (d1 <= matching.TH_HIGH) & (d1.to(torch.float32)
                                          < 0.9 * d2.to(torch.float32))
    vo_feat = matching.resolve_duplicates(
        torch.where(vo_good, vo_feat, INVALID), d1, frame.F)
    vo_ok = vo_feat >= 0
    fsafe = torch.where(vo_ok, vo_feat, 0).long()

    # joint pose optimization over map and VO observations
    pid = frame.point_ids
    okp = (pid >= 0) & frame.valid
    psafe = torch.where(okp, pid, 0).long()
    okp &= state.lm_valid[psafe]
    obs = pose_opt.PoseObs(
        uvr=torch.cat([frame.uvr, frame.uvr[fsafe]]),
        xyz=torch.cat([state.lm_xyz[psafe], vo_xyz]),
        inv_sigma2=torch.cat([
            scale_invsigma2(frame.octave, cfg.scale_factor),
            scale_invsigma2(frame.octave[fsafe], cfg.scale_factor)]),
        valid=torch.cat([okp, vo_ok]))
    R1, t1, inlier, n_tot = pose_opt.pose_optimize(cam, R, t, obs)
    F = frame.F
    n_map = (inlier[:F] & okp).sum().to(_I32)
    new_pid = torch.where(okp & ~inlier[:F], INVALID, pid)
    frame = frame._replace(pose7=lie.pose7_pack(R1, t1), point_ids=new_pid)
    return frame, n_map, n_tot


def track_frame_loc(cam: Camera, cfg: TrackConfig, state: MapState,
                    frame: Frame, last_frame: Frame, velocity7,
                    have_velocity: bool, ref_kf):
    """Localization-only per-frame step (reference "Localization Mode",
    Tracking.cc:395-485): motion-model tracking with temporary VO points;
    the local map decides only while enough real map points are in view
    (vo false). The map is never changed.

    Returns (frame, velocity7', flags) with flags = [ok, n_inliers,
    ref_matches, clipped, vo, n_total_mm] int32 (one host read)."""
    pred7, Rl, tl = _predict_pose7(last_frame, velocity7, have_velocity)
    f_mm, n_map_mm, n_tot_mm = track_motion_model_vo(
        cam, cfg, state, frame, last_frame, pred7)
    mm_ok = have_velocity & (n_tot_mm > 20)   # reference: nmatches > 20

    f_rf, _, n_in_rf = track_reference_keyframe(cam, cfg, state, frame,
                                                ref_kf, last_frame.pose7)
    f1 = _select(mm_ok, f_mm, f_rf)
    n_map1 = torch.where(mm_ok, n_map_mm, n_in_rf)
    stage1_ok = mm_ok | (n_in_rf >= cfg.min_inliers_motion)
    vo = stage1_ok & (n_map1 < 10)            # reference Tracking.cc:1280

    f2, n_in, _, _, clipped = track_local_map(cam, cfg, state, f1)
    ok = torch.where(vo, stage1_ok,
                     stage1_ok & (n_in >= cfg.min_inliers_map))
    frame_out = _select(stage1_ok, _select(vo, f1, f2), frame)
    ref_matches = ((state.kf_kp_point[ref_kf] >= 0)
                   & state.kf_kp_valid[ref_kf]).sum()
    R_c, t_c = lie.pose7_unpack(frame_out.pose7)
    R_li, t_li = lie.se3_inverse(Rl, tl)
    vel_new = lie.pose7_pack(*lie.se3_compose(R_c, t_c, R_li, t_li))
    flags = torch.stack([ok.to(_I32),
                         torch.where(vo, n_tot_mm, n_in).to(_I32),
                         ref_matches.to(_I32), clipped, vo.to(_I32),
                         n_tot_mm.to(_I32)])
    return frame_out, vel_new, flags


# ---------------------------------------------------------------------------
# Keyframe insertion
# ---------------------------------------------------------------------------

def insert_keyframe(cam: Camera, cfg: TrackConfig, state: MapState,
                    frame: Frame, frame_id, timestamp, parent_kf, slot):
    """Write the frame into keyframe slot `slot` (a free one, from
    `state.free_kf_slot()`) and spawn landmarks for close depth features
    without one, always at least the `min_close_spawn` closest (reference
    Tracking::CreateNewKeyFrame). Returns (state, frame)."""
    R, t = lie.pose7_unpack(frame.pose7)
    Rwc, twc = lie.se3_inverse(R, t)
    th_depth = cam.bf / cam.fx * cfg.th_depth
    n = frame.depth.shape[0]
    candidate = frame.valid & (frame.depth > 0) & (frame.point_ids < 0)
    depth_key = torch.where(candidate, frame.depth,
                            torch.full_like(frame.depth, float("inf")))
    rank = torch.empty((n,), dtype=_I32, device=frame.depth.device)
    rank[torch.argsort(depth_key, stable=True)] = torch.arange(
        n, dtype=_I32, device=rank.device)
    want = candidate & ((frame.depth < th_depth)
                        | (rank < cfg.min_close_spawn))
    slots, ok = state.allocate_points(want)
    xyz_cam = cam_ops.backproject(cam, frame.uvr[:, :2], frame.depth)
    xyz_w = lie.se3_apply(Rwc, twc, xyz_cam)
    dist = torch.linalg.norm(xyz_cam, dim=-1)
    maxd = dist * cfg.scale_factor ** frame.octave.to(torch.float32)
    mind = maxd / cfg.scale_factor ** (cfg.n_levels - 1)
    normal = xyz_w - twc
    normal = normal / torch.clamp(
        torch.linalg.norm(normal, dim=-1, keepdim=True), min=1e-9)
    ms = scatter.masked_set
    state = state._replace(
        lm_xyz=ms(state.lm_xyz, slots, ok, xyz_w),
        lm_valid=ms(state.lm_valid, slots, ok, True),
        lm_desc=ms(state.lm_desc, slots, ok, frame.desc),
        lm_angle=ms(state.lm_angle, slots, ok, frame.angle),
        lm_normal=ms(state.lm_normal, slots, ok, normal),
        lm_min_dist=ms(state.lm_min_dist, slots, ok, mind),
        lm_max_dist=ms(state.lm_max_dist, slots, ok, maxd),
        lm_ref_kf=ms(state.lm_ref_kf, slots, ok, slot),
        lm_first_seq=ms(state.lm_first_seq, slots, ok, state.next_seq),
    )
    point_ids = torch.where(ok, slots, frame.point_ids)
    state = state.add_keyframe(
        slot, frame.pose7, frame_id, timestamp, frame.uvr, frame.octave,
        frame.angle, frame.valid, frame.desc, point_ids, parent=parent_kf)
    return state, frame._replace(point_ids=point_ids)


# ---------------------------------------------------------------------------
# Monocular initialization
# ---------------------------------------------------------------------------

def mono_init_match(cfg: TrackConfig, f_ref: Frame, f_cur: Frame):
    """Windowed level-0 descriptor match for initialization (reference
    ORBmatcher::SearchForInitialization, window 100, ratio 0.9). Returns
    (match_idx (F_ref,) int32, n_matches)."""
    idx, dist = matching.search_windowed(
        matching.unpack_desc(f_ref.desc), matching.unpack_desc(f_cur.desc),
        f_ref.uvr[:, :2], f_cur.uvr[:, :2],
        f_ref.valid & (f_ref.octave == 0), f_cur.valid & (f_cur.octave == 0),
        radius=100.0, max_dist=matching.TH_LOW, ratio=0.9,
        angles=(f_ref.angle, f_cur.angle))
    idx = matching.resolve_duplicates(idx, dist, f_cur.F)
    return idx, (idx >= 0).sum()


def mono_init_compact(f_ref: Frame, f_cur: Frame, midx, out_cap: int):
    """Reduce the 2x-budget initializer frames (reference Tracking.cc:131-134)
    to the map's feature capacity, matched pairs first, and remap the match
    indices. Returns (f_ref', f_cur', midx')."""
    ok_pair = midx >= 0
    f_ref_c, ref_sel, _ = compact_frame(f_ref, ok_pair, out_cap)
    cur_matched = scatter.mark(f_cur.F, torch.where(ok_pair, midx, 0),
                               ok_pair)
    f_cur_c, _, cur_inv = compact_frame(f_cur, cur_matched, out_cap)
    m_old = midx[ref_sel]
    has = m_old >= 0
    midx_c = torch.where(has, cur_inv[torch.where(has, m_old, 0).long()],
                         INVALID)
    return f_ref_c, f_cur_c, midx_c


def mono_init_reconstruct(gen, cam: Camera, cfg: TrackConfig,
                          state: MapState, f_ref: Frame, f_cur: Frame,
                          match_idx, ts_ref, ts_cur, min_good: int = 80,
                          sets=None):
    """Two-view reconstruction and, on success, the initial map: KF0 at the
    identity, KF1 at [R|t], landmarks at the triangulated points scaled to
    median depth 1 (reference Tracking::MonocularInitialization +
    CreateInitialMapMonocular). `gen` draws the RANSAC sets; `sets`
    ((sets_H, sets_F)) skips the draw.

    Returns (state, f_cur', success, n_good)."""
    ok_pair = match_idx >= 0
    safe = torch.where(ok_pair, match_idx, 0).long()
    uv1 = f_ref.uvr[:, :2]
    uv2 = f_cur.uvr[safe][:, :2]
    res = twoview.initialize_two_view(gen, uv1, uv2, ok_pair, cam.K,
                                      sets=sets)
    good = res.good & ok_pair
    z = torch.where(good, res.points[:, 2],
                    torch.full_like(res.points[:, 2], float("nan")))
    scale = 1.0 / torch.clamp(_nanmedian_mid(z), min=1e-6)
    pts = res.points * scale
    pose0 = lie.pose7_identity(device=pts.device, dtype=pts.dtype)
    pose1 = lie.pose7_pack(res.R, res.t * scale)

    slots, alloc_ok = state.allocate_points(good)
    ok = good & alloc_ok
    dist = torch.linalg.norm(pts, dim=-1)
    maxd = dist * cfg.scale_factor ** f_ref.octave.to(torch.float32)
    mind = maxd / cfg.scale_factor ** (cfg.n_levels - 1)
    normal = pts / torch.clamp(torch.linalg.norm(pts, dim=-1, keepdim=True),
                               min=1e-9)
    ms = scatter.masked_set
    state = state._replace(
        lm_xyz=ms(state.lm_xyz, slots, ok, pts),
        lm_valid=ms(state.lm_valid, slots, ok, True),
        lm_desc=ms(state.lm_desc, slots, ok, f_cur.desc[safe]),
        lm_angle=ms(state.lm_angle, slots, ok, f_cur.angle[safe]),
        lm_normal=ms(state.lm_normal, slots, ok, normal),
        lm_min_dist=ms(state.lm_min_dist, slots, ok, mind),
        lm_max_dist=ms(state.lm_max_dist, slots, ok, maxd),
        lm_ref_kf=ms(state.lm_ref_kf, slots, ok, 0),
        lm_first_seq=ms(state.lm_first_seq, slots, ok, 0),
    )
    pid_ref = torch.where(ok, slots, INVALID)
    pid_cur = scatter.scatter_max(f_cur.F, safe, pid_ref, INVALID)
    state = state.add_keyframe(0, pose0, 0, ts_ref, f_ref.uvr, f_ref.octave,
                               f_ref.angle, f_ref.valid, f_ref.desc, pid_ref,
                               parent=INVALID)
    state = state.add_keyframe(1, pose1, 1, ts_cur, f_cur.uvr, f_cur.octave,
                               f_cur.angle, f_cur.valid, f_cur.desc, pid_cur,
                               parent=0)
    f_cur = f_cur._replace(pose7=pose1, point_ids=pid_cur)
    n_good = ok.sum()
    return state, f_cur, res.success & (n_good >= min_good), n_good
