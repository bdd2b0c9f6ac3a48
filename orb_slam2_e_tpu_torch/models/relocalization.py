"""Relocalization: BoW candidates -> PnP RANSAC -> pose refinement ->
full-map projection search.

Port of `orb_slam2_e_tpu/models/relocalization.py` (reference
Tracking::Relocalization with the E-extensions: the lowered >= 4 BoW match
gate, the full-map SearchByProjection after PnP, the S1/S2/S3 ladder). The
ladder itself, with the rigid and the non-rigid branch of every stage side
by side, is `SlamSystem._relocalize` / `_dual_optimize`; the non-rigid
branch is `models/deformable.py`.

The reference's `lax.scan`s become Python loops in the same order: over the
candidate keyframes, each drawing its PnP sets from the one generator in
turn (a masked candidate draws too, as the scan does), and over landmark
chunks of the full-map search. The per-candidate results stay on the
device; the caller reads the best one once.
"""

from __future__ import annotations

import torch

from ..ops import lie, matching, pnp, scatter
from ..ops.camera import Camera
from .frame import Frame
from .map_state import MapState, INVALID
from .tracking import (TrackConfig, search_landmarks_projected, bind_matches,
                       optimize_frame_pose)

MIN_BOW_MATCHES = 4       # E-addition (reference Tracking.cc:1768: >= 4)
MIN_PNP_FULLMAP = 12      # reference PnPsolver.cc:396 (>= 12 full-map)
RELOC_GOOD = 50           # final acceptance (reference Tracking.cc:2110)
N_HYP = 128               # PnP hypotheses per candidate


def candidate_matches(state: MapState, frame: Frame, kf, bits_f=None):
    """Descriptor matches of keyframe `kf`'s landmarks into the frame
    (ratio 0.75, TH_LOW, injective). Returns (kp_pid (F_kf,), pair
    (F_kf,) bool, fsafe (F_kf,) frame rows, xyz (F_kf, 3))."""
    if bits_f is None:
        bits_f = matching.unpack_desc(frame.desc)
    kp_pid = state.kf_kp_point[kf]
    kp_ok = state.kf_kp_valid[kf] & (kp_pid >= 0)
    safe = torch.where(kp_ok, kp_pid, 0).long()
    kp_ok &= state.lm_valid[safe]
    dmat = matching.hamming_matrix(matching.unpack_desc(state.kf_desc[kf]),
                                   bits_f)
    bi, d1, d2 = matching.masked_best2(dmat, kp_ok[:, None]
                                       & frame.valid[None, :])
    good = (d1 <= matching.TH_LOW) & (d1.to(torch.float32)
                                      < 0.75 * d2.to(torch.float32))
    midx = matching.resolve_duplicates(torch.where(good, bi, INVALID), d1,
                                       frame.F)
    pair = midx >= 0
    return kp_pid, pair, torch.where(pair, midx, 0).long(), state.lm_xyz[safe]


def relocalize_candidates(gen, cam: Camera, cfg: TrackConfig,
                          state: MapState, frame: Frame, cand_kfs, cand_ok,
                          sets=None):
    """Per candidate keyframe: descriptor match -> PnP RANSAC -> inlier
    count; the best candidate's pose seeds the ladder. `sets`: an optional
    list of (sets_g, anchors) per candidate, skipping the draws.

    Returns (pose7_best (7,), n_inliers_best (-1 for a masked
    candidate), point_ids_best (F,)), all on the device."""
    bits_f = matching.unpack_desc(frame.desc)
    poses, n_ins, pids = [], [], []
    for i, kf in enumerate(cand_kfs.tolist()):
        kp_pid, pair, fsafe, xyz = candidate_matches(state, frame, kf,
                                                     bits_f)
        uv = frame.uvr[fsafe][:, :2]
        enough = pair.sum() >= MIN_BOW_MATCHES
        sg, an = (None, None) if sets is None else sets[i]
        res = pnp.ransac_pnp(gen, xyz, uv, pair & enough, cam.K,
                             n_hyp=N_HYP, sets=sg, anchors=an)
        poses.append(lie.pose7_pack(res.R[0], res.t[0]))
        # frame point ids implied by the candidate's inliers
        pids.append(scatter.scatter_max(
            frame.F, fsafe, torch.where(pair & res.inliers_best, kp_pid,
                                        INVALID), INVALID))
        n_ins.append(torch.where(cand_ok[i], res.n_inliers[0], -1))
    best = torch.argmax(torch.stack(n_ins))            # first maximum
    return torch.stack(poses)[best], torch.stack(n_ins)[best], \
        torch.stack(pids)[best]


def fullmap_search(cam: Camera, cfg: TrackConfig, state: MapState,
                   frame: Frame, radius_scale: float, max_hamming: int):
    """Project the whole landmark pool from the frame's pose and bind new
    matches (the E-overload ORBmatcher::SearchByProjection(Frame&, Map*)),
    in chunks of `cfg.local_points_cap` landmarks so every landmark is
    searched. Bound features are never stolen, so chunk-by-chunk binding
    is consistent. Returns (frame, n_bound_total)."""
    L = cfg.local_points_cap
    P = state.P
    R, t = lie.pose7_unpack(frame.pose7)
    ar = torch.arange(L, device=state.device)
    for start in range(0, P, L):
        raw = start + ar
        ids = torch.clamp(raw, 0, P - 1)
        mask = state.lm_valid[ids] & (raw < P)
        best_feat, dists, _ = search_landmarks_projected(
            cam, cfg, R, t, state.lm_xyz[ids], state.lm_desc[ids], mask,
            state.lm_max_dist[ids], state.lm_min_dist[ids],
            state.lm_normal[ids], frame, radius_scale=radius_scale,
            max_hamming=max_hamming, ratio=1.0, check_view_cos=False,
            angles=state.lm_angle[ids])
        frame = bind_matches(frame, torch.where(mask, ids, INVALID).to(
            torch.int32), best_feat, dists)
    return frame, ((frame.point_ids >= 0) & frame.valid).sum()
