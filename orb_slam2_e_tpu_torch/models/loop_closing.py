"""Loop closing: detection bookkeeping, Sim3 computation and verification,
loop correction with the essential-graph optimization, loop fusion and
global BA.

Port of `orb_slam2_e_tpu/models/loop_closing.py` (reference LoopClosing.cc):
DetectLoop (BoW candidates gated by a covisible minimum score, consistent
over 3 consecutive keyframes) -> ComputeSim3 (descriptor matches -> Sim3
RANSAC -> refinement, >= 20 inliers) -> the verification ladder ->
CorrectLoop (the corrected Sim3 propagated over the covisible neighborhood,
OptimizeEssentialGraph) -> SearchAndFuse -> global BA on a snapshot, merged
back into the live map.

Every function keeps the reference's fixed capacities (`N_FUSE_PTS`,
`N_FUSE_KFS`, 4K covisibility edges, `obs_cap`): compacted index lists are
padded to their capacity and masked by position, so no shape depends on the
data and nothing is read by the host inside a function. Keyframe arguments
may be Python ints or integer tensors; rows are taken with `index_select`,
which does not wait for the device.

Two properties of the reference are kept on purpose (ROADMAP Q3 #6): the
projection searches compare the distance divided by the Sim3 scale against
the landmark's metric bounds, and the covisibility rows come from
`MapState.covisibility_row` with its max-scatter on landmark slot 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ba, lie, matching, pose_graph, scatter, sim3_solve
from ..ops import camera as cam_ops
from ..ops.camera import Camera
from .frame import scale_invsigma2
from .map_state import MapState, INVALID

MIN_SIM3_MATCHES = 20     # reference LoopClosing.cc:289 (>= 20 for solver)
MIN_SIM3_INLIERS = 20     # reference: OptimizeSim3 >= 20 inliers
CONSISTENCY_TH = 3        # mnCovisibilityConsistencyTh (LoopClosing.cc:46)
COVIS_EDGE_MIN = 100      # essential-graph covisibility edges
N_FUSE_KFS = 16           # corrected-neighborhood capacity of SearchAndFuse
N_FUSE_PTS = 4096         # loop-side landmark capacity

_I32 = torch.int32


class LoopDetector:
    """Host-side covisibility-group consistency over consecutive keyframes
    (reference DetectLoop's vConsistentGroups, LoopClosing.cc:150-225): a
    candidate's group is the candidate and its covisible keyframes; it is
    consistent with a previous group when the two overlap, so the best
    candidate may shift among covisible neighbors without breaking the
    chain. Confirmed when a chain reaches CONSISTENCY_TH overlaps."""

    def __init__(self):
        self.groups = []          # list of (frozenset group, chain count)

    def update(self, cand_groups):
        """cand_groups: list of (candidate_kf, set_of_group_kfs). Returns
        the list of confirmed candidate keyframes."""
        new_groups = []
        confirmed = []
        for cand, grp in cand_groups:
            grp = frozenset(grp) | {cand}
            best = 0
            for prev_grp, prev_cnt in self.groups:
                if grp & prev_grp:
                    best = max(best, prev_cnt + 1)
            if best >= CONSISTENCY_TH:
                confirmed.append(cand)
            new_groups.append((grp, best))
        self.groups = new_groups
        return confirmed

    def reset(self):
        self.groups = []


def _idx1(kf, device) -> torch.Tensor:
    """A keyframe argument (int or integer tensor) as a (1,) int64 index."""
    return torch.as_tensor(kf, device=device).reshape(1).long()


def _row(arr: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    return arr.index_select(0, k1)[0]


def _bound_points(state: MapState, k1):
    """Keyframe k1's landmark ids, their clamped form, and the mask of
    features bound to a live landmark."""
    p = _row(state.kf_kp_point, k1)
    safe = torch.where(p >= 0, p, 0).long()
    ok = _row(state.kf_kp_valid, k1) & (p >= 0) & state.lm_valid[safe]
    return p, safe, ok


def _predict_octave(dist, max_dist, scale_factor: float, n_levels: int):
    ratio = max_dist / torch.clamp(dist, min=1e-6)
    lvl = torch.ceil(torch.log(torch.clamp(ratio, min=1e-6))
                     / np.log(scale_factor)).to(_I32)
    return torch.clamp(lvl, 0, n_levels - 1)


def match_keyframes(state: MapState, kf1, kf2):
    """Landmark-level descriptor matches between two keyframes (reference
    ORBmatcher::SearchByBoW(KF, KF), ratio 0.75). Returns (idx2_for_f1
    (F,), pair_valid (F,))."""
    a, b = _idx1(kf1, state.device), _idx1(kf2, state.device)
    _, _, ok1 = _bound_points(state, a)
    _, _, ok2 = _bound_points(state, b)
    dmat = matching.hamming_matrix(
        matching.unpack_desc(_row(state.kf_desc, a)),
        matching.unpack_desc(_row(state.kf_desc, b)))
    bi, d1, d2 = matching.masked_best2(dmat, ok1[:, None] & ok2[None, :])
    good = (d1 <= matching.TH_LOW) & (d1.to(torch.float32)
                                      < 0.75 * d2.to(torch.float32))
    midx = matching.resolve_duplicates(
        torch.where(good, bi, INVALID).to(_I32), d1, state.F)
    return midx, midx >= 0


def _pair_geometry(state: MapState, cur, cand, safe, scale_factor):
    """Camera-frame points, pixels and weights of the pairs (cur feature i,
    cand feature safe[i])."""
    p1, s1, _ = _bound_points(state, cur)
    p2, s2, _ = _bound_points(state, cand)
    R1, t1 = lie.pose7_unpack(_row(state.kf_pose7, cur))
    R2, t2 = lie.pose7_unpack(_row(state.kf_pose7, cand))
    xyz1 = lie.se3_apply(R1, t1, state.lm_xyz[s1])
    xyz2 = lie.se3_apply(R2, t2, state.lm_xyz[s2])[safe]
    uv1 = _row(state.kf_kp_uvr, cur)[:, :2]
    uv2 = _row(state.kf_kp_uvr, cand)[safe][:, :2]
    inv1 = scale_invsigma2(_row(state.kf_kp_octave, cur), scale_factor)
    inv2 = scale_invsigma2(_row(state.kf_kp_octave, cand)[safe],
                           scale_factor)
    return p1, p2, (R2, t2), xyz1, xyz2, uv1, uv2, inv1, inv2


def compute_sim3(gen, cam: Camera, state: MapState, kf_cur, kf_cand,
                 scale_factor: float = 1.2, fix_scale: bool = False,
                 sets=None):
    """Sim3 between the current and the candidate keyframe from matched
    landmarks (reference LoopClosing::ComputeSim3). `gen` draws the RANSAC
    sets; `sets` skips the draw. Returns (R12, t12, s12, n_inliers), S12
    mapping candidate-camera into current-camera coordinates."""
    cur, cand = _idx1(kf_cur, state.device), _idx1(kf_cand, state.device)
    midx, pair = match_keyframes(state, cur, cand)
    safe = torch.where(pair, midx, 0).long()
    _, _, _, xyz1, xyz2, uv1, uv2, inv1, inv2 = _pair_geometry(
        state, cur, cand, safe, scale_factor)
    res = sim3_solve.ransac_sim3(
        gen, xyz1, xyz2, pair & (pair.sum() >= MIN_SIM3_MATCHES), uv1, uv2,
        cam.K, fix_scale=fix_scale, sets=sets)
    R, t, s, n_in, _ = sim3_solve.refine_sim3(
        res.R, res.t, res.s, xyz1, xyz2, res.inliers, uv1, uv2, cam.K,
        inv1, inv2, fix_scale=fix_scale)
    return R, t, s, n_in


def _project_sim3(cam: Camera, R, t, s, xc):
    """Project camera-frame points through a Sim3 into the other camera."""
    x = s * torch.einsum('ij,pj->pi', R, xc) + t
    uv, z = cam_ops.project(cam, x)
    return x, uv, z


def _projection_match(cam: Camera, state: MapState, lids, live, x, uv, z,
                      s, k_to, radius_th, scale_factor, n_levels):
    """Windowed Hamming search of landmarks `lids` (live where `live`),
    projected to `uv` at Sim3-frame position `x`, against keyframe k_to's
    features. The scale-invariance window is tested on the distance
    divided by the Sim3 scale `s`, as the reference does. Returns
    (best (L,), d1 (L,))."""
    dist = torch.linalg.norm(x, dim=1) / torch.clamp(s, min=1e-9)
    ok = (live & (z > 0) & cam_ops.in_image(cam, uv)
          & (dist >= 0.8 * state.lm_min_dist[lids])
          & (dist <= 1.2 * state.lm_max_dist[lids]))
    oct_pred = _predict_octave(dist, state.lm_max_dist[lids], scale_factor,
                               n_levels)
    radius = radius_th * scale_factor ** oct_pred.to(torch.float32)
    dmat = matching.hamming_matrix(
        matching.unpack_desc(state.lm_desc[lids]),
        matching.unpack_desc(_row(state.kf_desc, k_to)))
    mask = matching.window_mask(uv, _row(state.kf_kp_uvr, k_to)[:, :2],
                                radius)
    mask &= matching.octave_range_mask(oct_pred,
                                       _row(state.kf_kp_octave, k_to))
    mask &= ok[:, None] & _row(state.kf_kp_valid, k_to)[None, :]
    best, d1, _ = matching.masked_best2(dmat, mask)
    return best, d1


def _sim3_proj_match(cam: Camera, state: MapState, kf_from, kf_to,
                     R, t, s, radius_th, scale_factor, n_levels,
                     max_hamming):
    """Project kf_from's landmarks through the Sim3 (from -> to camera)
    onto kf_to's features. Returns midx (F,): the feature of kf_to matched
    to each feature of kf_from, or -1."""
    k_from, k_to = _idx1(kf_from, state.device), _idx1(kf_to, state.device)
    _, pid_safe, ok_from = _bound_points(state, k_from)
    Rf, tf = lie.pose7_unpack(_row(state.kf_pose7, k_from))
    xc = lie.se3_apply(Rf, tf, state.lm_xyz[pid_safe])
    x_to, uv, z = _project_sim3(cam, R, t, s, xc)
    best, d1 = _projection_match(cam, state, pid_safe, ok_from, x_to, uv, z,
                                 s, k_to, radius_th, scale_factor, n_levels)
    return torch.where(d1 <= max_hamming, best, INVALID).to(_I32)


def _group_landmarks(state: MapState, k1, min_covis: int):
    """Landmarks seen by keyframe k1 or a keyframe sharing at least
    `min_covis` points with it, compacted to N_FUSE_PTS: (ids, live,
    count)."""
    covis = state.covisibility_row(k1)
    side = (covis >= min_covis).index_fill(0, k1, True)
    in_side = side[:, None] & state.kf_kp_valid & (state.kf_kp_point >= 0)
    mask = scatter.mark(state.P, torch.where(
        in_side, state.kf_kp_point, 0).reshape(-1), in_side.reshape(-1))
    mask &= state.lm_valid
    ids, live = scatter.nonzero_static(mask, N_FUSE_PTS)
    return ids, live, mask.sum()


def verify_sim3(cam: Camera, state: MapState, kf_cur, kf_cand,
                R12, t12, s12, scale_factor: float = 1.2,
                n_levels: int = 8, fix_scale: bool = False):
    """The verification ladder between RANSAC + refinement and any map
    correction (reference LoopClosing.cc:306-400):

      1. SearchBySim3 widening: each side's landmarks are projected through
         the Sim3 into the other keyframe (th = 7.5), mutually consistent
         matches are kept, joined with the descriptor matches, and the Sim3
         is refined again on them (>= 20 inliers).
      2. The loop keyframe's whole covisibility group is projected through
         the corrected pose into the current keyframe (th = 10); the loop
         is accepted only with >= 40 matches in all.

    Returns (R, t, s, n_inliers, n_total_proj, clip_bit)."""
    F = state.F
    dev = state.device
    cur, cand = _idx1(kf_cur, dev), _idx1(kf_cand, dev)
    # ---- stage 1: mutual widening ----
    R21 = R12.T
    s21 = 1.0 / torch.clamp(s12, min=1e-9)
    t21 = -s21 * (R21 @ t12)
    m12 = _sim3_proj_match(cam, state, cand, cur, R12, t12, s12, 7.5,
                           scale_factor, n_levels, matching.TH_HIGH)
    m21 = _sim3_proj_match(cam, state, cur, cand, R21, t21, s21, 7.5,
                           scale_factor, n_levels, matching.TH_HIGH)
    j_idx = torch.arange(F, dtype=_I32, device=dev)
    ok_m = m12 >= 0                                # cand j -> cur i
    back = m21[torch.where(ok_m, m12, 0).long()]   # cur i -> cand ?
    mutual = ok_m & (back == j_idx)
    # indexed by the CUR feature i: its cand feature j
    pair_cand = scatter.scatter_max(
        F, torch.where(mutual, m12, 0), torch.where(mutual, j_idx, INVALID),
        INVALID)
    bow_idx, bow_ok = match_keyframes(state, cur, cand)
    pair = torch.where(pair_cand >= 0, pair_cand,
                       torch.where(bow_ok, bow_idx, INVALID))
    pair_ok = pair >= 0
    safe = torch.where(pair_ok, pair, 0).long()
    p1, p2, (R2, t2), xyz1, xyz2, uv1, uv2, inv1, inv2 = _pair_geometry(
        state, cur, cand, safe, scale_factor)
    pair_ok = pair_ok & (p1 >= 0) & (p2[safe] >= 0)
    Rr, tr, sr, n_in, inl = sim3_solve.refine_sim3(
        R12, t12, s12, xyz1, xyz2, pair_ok, uv1, uv2, cam.K, inv1, inv2,
        fix_scale=fix_scale)

    # ---- stage 2: the loop group's points, >= 40 in all ----
    lids, lsub, n_loop = _group_landmarks(state, cand, 1)
    clip = (n_loop > N_FUSE_PTS).to(_I32)
    # world -> cand camera -> (refined Sim3) -> cur camera
    xc2 = lie.se3_apply(R2, t2, state.lm_xyz[lids])
    x_cur, uv, z = _project_sim3(cam, Rr, tr, sr, xc2)
    best, d1 = _projection_match(cam, state, lids, lsub, x_cur, uv, z, sr,
                                 cur, 10.0, scale_factor, n_levels)
    midx = matching.resolve_duplicates(
        torch.where(d1 <= matching.TH_LOW, best, INVALID).to(_I32), d1, F)
    # the gate counts, per CUR feature, the union of the stage-1 inlier
    # pairs and the stage-2 matches (reference LoopClosing.cc:353-376)
    stage2_feat = scatter.mark(F, torch.where(midx >= 0, midx, 0),
                               midx >= 0)
    n_total = (stage2_feat | (pair_ok & inl)).sum()
    return Rr, tr, sr, n_in, n_total, clip


def essential_graph_edges(state: MapState, kf_cur, kf_loop):
    """Edges of the essential graph: the spanning tree, the covisibility
    edges with >= COVIS_EDGE_MIN shared points (upper triangle, at most 4K),
    every loop edge of past closures and, last, the new loop edge. Returns
    (edges_i, edges_j, edge_ok, clip_edges)."""
    K = state.K
    dev = state.device
    ar = torch.arange(K, dtype=_I32, device=dev)
    tree_ok = (state.kf_parent >= 0) & state.kf_valid
    e1_j = torch.clamp(state.kf_parent, 0, K - 1)
    W = state.covisibility_matrix()
    strong = ((W >= COVIS_EDGE_MIN) & (ar[:, None] < ar[None, :])).reshape(-1)
    e_cap = 4 * K
    clip_edges = (strong.sum() > e_cap).to(_I32)
    flat_idx, _ = scatter.nonzero_static(strong, e_cap)
    cov_ok = strong[flat_idx]          # padding aliases (0, 0): not strong
    e2_i = (flat_idx // K).to(_I32)
    e2_j = (flat_idx % K).to(_I32)
    le = state.kf_loop_edge.reshape(-1)                       # (K * 4,)
    e4_i = ar.repeat_interleave(state.kf_loop_edge.shape[1])
    e4_j = torch.clamp(le, 0, K - 1)
    past_ok = ((le >= 0) & state.kf_valid[e4_i.long()]
               & state.kf_valid[e4_j.long()])
    e3_i = _idx1(kf_cur, dev).to(_I32)
    e3_j = _idx1(kf_loop, dev).to(_I32)
    return (torch.cat([ar, e2_i, e4_i, e3_i]),
            torch.cat([e1_j, e2_j, e4_j, e3_j]),
            torch.cat([tree_ok, cov_ok, past_ok,
                       torch.ones((1,), dtype=torch.bool, device=dev)]),
            clip_edges)


def _move_points(xyz, sim8_from, sim8_to):
    """X' = S_to^-1 * S_from * X, per point."""
    Rf, tf, sf = lie.sim8_unpack(sim8_from)
    xc = lie.sim3_apply(Rf, tf, sf, xyz)
    return lie.sim3_apply(*lie.sim3_inverse(*lie.sim8_unpack(sim8_to)), xc)


def correct_and_optimize_graph(state: MapState, kf_cur, kf_loop,
                               R12, t12, s12, n_iters: int = 20):
    """Correct the covisible neighborhood of kf_cur with the loop Sim3, run
    the essential-graph optimization and move the landmarks with their
    reference keyframes (reference LoopClosing::CorrectLoop +
    Optimizer::OptimizeEssentialGraph). S12 maps loop-keyframe camera
    coordinates into the current camera's, so the corrected pose is
    Scw(cur) = S12 * Scw(loop). Returns (state, final cost, clip_edges)."""
    K = state.K
    dev = state.device
    cur, loop = _idx1(kf_cur, dev), _idx1(kf_loop, dev)
    R, t = lie.pose7_unpack(state.kf_pose7)
    ones = torch.ones((K,), dtype=t.dtype, device=dev)
    sim8_old = lie.sim8_pack(R, t, ones)

    # corrected current keyframe, propagated over its covisible keyframes:
    # S_i_corr = (T_i * T_cur^-1) * S_cur_corr
    Rl, tl = lie.pose7_unpack(_row(state.kf_pose7, loop))
    Rc, tc, sc = lie.sim3_compose(R12, t12, s12, Rl, tl, ones[0])
    neigh = (state.covisibility_row(cur) >= 15).index_fill(0, cur, True)
    Rcur, tcur = lie.pose7_unpack(_row(state.kf_pose7, cur))
    R_rel, t_rel = lie.se3_compose(R, t, *lie.se3_inverse(Rcur, tcur))
    sim8_corr = lie.sim8_pack(*lie.sim3_compose(R_rel, t_rel, ones,
                                                Rc, tc, sc))
    sim8 = torch.where(neigh[:, None], sim8_corr, sim8_old)

    # landmarks owned by a corrected keyframe: X_corr = S_corr^-1 S_old X
    owner = torch.clamp(state.lm_ref_kf, 0, K - 1).long()
    owner_corr = neigh[owner] & state.lm_valid
    lm_xyz = torch.where(
        owner_corr[:, None],
        _move_points(state.lm_xyz, sim8_old[owner], sim8[owner]),
        state.lm_xyz)

    edges_i, edges_j, edge_ok, clip_edges = essential_graph_edges(
        state, cur, loop)
    ei, ej = edges_i.long(), edges_j.long()
    # measurements: the uncorrected relative poses on the old edges (they
    # pull the map back into consistency), the corrected one on the new
    meas = torch.cat([
        pose_graph.build_relative_measurements(sim8_old[ei[:-1]],
                                               sim8_old[ej[:-1]]),
        pose_graph.build_relative_measurements(sim8[ei[-1:]],
                                               sim8[ej[-1:]])])
    fixed = torch.zeros((K,), dtype=torch.bool,
                        device=dev).index_fill(0, loop, True)
    pg = (pose_graph.optimize_pose_graph
          if K <= pose_graph.DENSE_POSE_GRAPH_MAX_K
          else pose_graph.optimize_pose_graph_cg)
    out8, costs = pg(sim8, state.kf_valid, fixed, edges_i, edges_j, meas,
                     edge_ok, n_iters=n_iters)

    # SE3 poses back, landmarks following their reference keyframe:
    # X_new = S_new^-1 * S_used * X
    pose7_new = pose_graph.sim3_to_se3(out8)
    lm_xyz = torch.where(state.lm_valid[:, None],
                         _move_points(lm_xyz, sim8[owner], out8[owner]),
                         lm_xyz)

    # the loop edge is kept both ways, in the first free of 4 slots
    def add_edge(le, a, b):
        row = _row(le, a)
        idx = torch.clamp((row >= 0).sum(), max=row.shape[0] - 1)
        slot = torch.arange(row.shape[0], device=dev) == idx
        return le.index_copy(0, a, torch.where(slot, b.to(le.dtype),
                                               row)[None])

    le_new = add_edge(add_edge(state.kf_loop_edge, cur, loop), loop, cur)
    state = state._replace(
        kf_pose7=torch.where(state.kf_valid[:, None], pose7_new,
                             state.kf_pose7),
        lm_xyz=lm_xyz, kf_loop_edge=le_new)
    return state, costs[-1], clip_edges


def search_and_fuse(cam: Camera, state: MapState, kf_cur, kf_loop,
                    scale_factor: float = 1.2, n_levels: int = 8,
                    trace: list | None = None):
    """Project the loop-side landmarks into every keyframe of the corrected
    neighborhood and fuse duplicates, the loop point replacing the local
    one (reference LoopClosing::SearchAndFuse with ORBmatcher::Fuse, th = 4,
    and MapPoint::Replace). The map is threaded through the 16 keyframes
    one after the other, without a host read. Returns (state, n_fused,
    clip).

    `trace`, a list, receives one dict of 0-d tensors per slot of the
    neighborhood: how many loop landmarks survive each test of the
    projection in turn (live, in front, in the image, in the scale window,
    a feature in the search window, the descriptor distance, one per
    feature), and how many bind or replace."""
    K, P, F = state.K, state.P, state.F
    dev = state.device
    cur, loop = _idx1(kf_cur, dev), _idx1(kf_loop, dev)
    lids, lsub, n_loop = _group_landmarks(state, loop, 15)

    # corrected neighborhood: kf_cur and its covisible keyframes
    corr = (state.covisibility_row(cur) >= 15).index_fill(0, cur, True)
    corr &= state.kf_valid
    ckfs, c_ok = scatter.nonzero_static(corr, N_FUSE_KFS)
    clip = ((n_loop > N_FUSE_PTS) | (corr.sum() > N_FUSE_KFS)).to(_I32)
    one = torch.ones((), dtype=state.lm_xyz.dtype, device=dev)
    lids32 = lids.to(_I32)
    table0 = torch.arange(P, dtype=_I32, device=dev)

    fused = torch.zeros((), dtype=torch.int64, device=dev)
    for c in range(N_FUSE_KFS):
        kf = ckfs[c:c + 1]
        R, t = lie.pose7_unpack(_row(state.kf_pose7, kf))
        xc = lie.se3_apply(R, t, state.lm_xyz[lids])
        uv, z = cam_ops.project(cam, xc)
        live = lsub & c_ok[c]
        best, d1 = _projection_match(cam, state, lids, live, xc, uv, z, one,
                                     kf, 4.0, scale_factor, n_levels)
        midx = matching.resolve_duplicates(
            torch.where(d1 <= matching.TH_LOW, best, INVALID).to(_I32), d1,
            F)
        pair_ok = midx >= 0
        f_safe = torch.where(pair_ok, midx, 0)
        row = _row(state.kf_kp_point, kf)
        q = row[f_safe.long()]                      # the current binding
        p = torch.where(pair_ok, lids32, INVALID)   # the loop point
        # an unbound feature takes the loop point
        bindA = pair_ok & (q < 0)
        new_row = torch.maximum(row, scatter.scatter_max(
            F, torch.where(bindA, f_safe, 0), torch.where(bindA, p, INVALID),
            INVALID))
        pt = state.kf_kp_point.index_copy(0, kf, new_row[None])
        # bound to another point: the loop point replaces it everywhere
        bindB = pair_ok & (q >= 0) & (q != p)
        loser = torch.where(bindB, q, INVALID)
        table = scatter.masked_set(table0, loser, bindB, p)
        remapped = torch.where(
            pt >= 0, table[torch.where(pt >= 0, pt, 0).long()], pt)
        dead = scatter.mark(P, torch.where(bindB, loser, 0), bindB)
        state = state._replace(kf_kp_point=remapped,
                               lm_valid=state.lm_valid & ~dead)
        fused = fused + bindA.sum() + bindB.sum()
        if trace is not None:
            seen = live & (z > 0)
            inside = seen & cam_ops.in_image(cam, uv)
            dist = torch.linalg.norm(xc, dim=1)
            scaled = (inside & (dist >= 0.8 * state.lm_min_dist[lids])
                      & (dist <= 1.2 * state.lm_max_dist[lids]))
            trace.append({"kf": kf[0], "live": live.sum(),
                          "in_front": seen.sum(), "in_image": inside.sum(),
                          "scale_window": scaled.sum(),
                          "candidate": (d1 < matching.BIG).sum(),
                          "desc_dist": (d1 <= matching.TH_LOW).sum(),
                          "one_per_feature": pair_ok.sum(),
                          "bound": bindA.sum(), "replaced": bindB.sum()})
    return state, fused, clip


def gba_problem(cam: Camera, state: MapState, scale_factor: float = 1.2,
                obs_cap: int = 131072):
    """The full-map BA problem of a map snapshot, in tensors of its own
    (reference Optimizer::GlobalBundleAdjustemnt setup), so the live map
    can go on changing while chunks run. Gauge: keyframe slot 0 is fixed.
    Returns (prob, clip)."""
    K, F = state.K, state.F
    obs_ok = (state.kf_kp_valid & (state.kf_kp_point >= 0)
              & state.kf_valid[:, None]).reshape(-1)
    clipped = (obs_ok.sum() > obs_cap).to(_I32)
    # padding aliases flat index 0, which may be a live observation: it is
    # masked by position
    sel, live = scatter.nonzero_static(obs_ok, obs_cap)
    prob = ba.BAProblem(
        cam_pose7=state.kf_pose7.clone(),
        cam_free=state.kf_valid & (torch.arange(K, device=state.device)
                                   != 0),
        points=state.lm_xyz.clone(),
        point_valid=state.lm_valid.clone(),
        obs_cam=(sel // F).to(_I32),
        obs_point=torch.where(live, state.kf_kp_point.reshape(-1)[sel], 0),
        obs_uvr=state.kf_kp_uvr.reshape(-1, 3)[sel],
        obs_inv_sigma2=scale_invsigma2(
            state.kf_kp_octave.reshape(-1)[sel], scale_factor),
        obs_valid=live)
    return prob, clipped


def gba_merge(state: MapState, res_pose7, res_pts,
              snap_kf_seq, snap_lm_first_seq, snap_lm_valid):
    """Merge a finished global-BA result, computed on a snapshot, into the
    current map, which may have gained keyframes and landmarks meanwhile
    (the reference's staged write-back, LoopClosing.cc:684-739):

    - a keyframe whose slot still holds the same keyframe (kf_seq) takes
      its optimized pose;
    - a keyframe created since keeps its pose relative to its
      spanning-tree parent, re-anchored on the parent's corrected pose;
    - a landmark of the snapshot (same slot, same birth seq) takes its
      optimized position; one created since moves with its reference
      keyframe."""
    K = state.K
    same_kf = state.kf_valid & (state.kf_seq == snap_kf_seq)
    R_now, t_now = lie.pose7_unpack(state.kf_pose7)
    pose_m = torch.where(same_kf[:, None], res_pose7, state.kf_pose7)
    corrected = same_kf
    par = torch.clamp(state.kf_parent, 0, K - 1).long()
    R_rel, t_rel = lie.se3_compose(R_now, t_now, *lie.se3_inverse(
        R_now[par], t_now[par]))
    for _ in range(4):                   # a few hops down the tree
        can = (state.kf_valid & ~corrected & (state.kf_parent >= 0)
               & corrected[par])
        Rp_m, tp_m = lie.pose7_unpack(pose_m[par])
        pose_c = lie.pose7_pack(*lie.se3_compose(R_rel, t_rel, Rp_m, tp_m))
        pose_m = torch.where(can[:, None], pose_c, pose_m)
        corrected = corrected | can
    same_lm = (state.lm_valid & snap_lm_valid
               & (state.lm_first_seq == snap_lm_first_seq))
    xyz = torch.where(same_lm[:, None], res_pts, state.lm_xyz)
    new_lm = state.lm_valid & ~same_lm
    ref = torch.clamp(state.lm_ref_kf, 0, K - 1).long()
    ref_moved = corrected[ref] & (state.lm_ref_kf >= 0)
    x_cam = lie.se3_apply(R_now[ref], t_now[ref], state.lm_xyz)
    Rm, tm = lie.pose7_unpack(pose_m[ref])
    x_new = lie.se3_apply(*lie.se3_inverse(Rm, tm), x_cam)
    xyz = torch.where((new_lm & ref_moved)[:, None], x_new, xyz)
    return state._replace(kf_pose7=pose_m, lm_xyz=xyz)


def global_ba(cam: Camera, state: MapState, scale_factor: float = 1.2,
              n_outer: int = 10, cg_iters: int = 50, obs_cap: int = 131072):
    """Synchronous full-map bundle adjustment (for offline use; the online
    path runs the same solve in chunks through gba_problem,
    ba.ba_pcg_chunk and gba_merge). Returns (state, clipped: bool)."""
    prob, clipped = gba_problem(cam, state, scale_factor, obs_cap)
    res = ba.ba_solve_pcg(cam, prob, n_outer=n_outer, cg_iters=cg_iters)
    return state._replace(
        kf_pose7=torch.where(state.kf_valid[:, None], res.cam_pose7,
                             state.kf_pose7),
        lm_xyz=torch.where(state.lm_valid[:, None], res.points,
                           state.lm_xyz)), bool(clipped)
