"""Non-rigid pose optimization: FEM-regularized relocalization.

Port of `orb_slam2_e_tpu/models/deformable.py` (reference
Optimizer::PoseOptimizationNR, src/Optimizer.cc:478-834), the centerpiece of
the deformable mode: optimize the frame pose AND the tracked landmark
positions (the map is allowed to deform), with reprojection edges to the
frame and to every observing keyframe (all keyframes fixed), while the
accept/reject cost of each LM trial carries the FEM strain energy of the
current landmark displacements:

    tempChi = w_rE * reprojChi2 + w_sE * nsE      (w_rE = 1, w_sE = 5)

Per relocalization attempt: gather the problem -> one packed read for the
host mesher -> mesh build (host Delaunay, ops/fem.build_mesh) -> element
stiffness, once -> 10 + 10 LM iterations with the augmented cost -> one read
of the inlier count -> write back the pose and the moved landmarks.

The strain term enters only the accept/reject comparison, so a float32
difference in it can flip an LM step: results agree with the reference
within its own spread under 1-ulp moves of its inputs, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import lie, ba, fem, geometry, scatter
from ..ops.camera import Camera
from ..ops import camera as cam_ops
from ..ops.orb import top_k
from .frame import Frame, scale_invsigma2
from .map_state import MapState, INVALID
from .tracking import TrackConfig

_I32 = torch.int32


class NRConfig(NamedTuple):
    el_type: int = 1          # RelocParam.nElType: 1 = C3D6, 2 = C3D8
    n_fixed_kfs: int = 8      # observing keyframes included (fixed)
    obs_cap: int = 8192
    pts_cap: int = 1024       # tracked landmark capacity (= frame F typically)
    mesh_nodes: int = 4096
    mesh_elems: int = 4096
    w_se: float = fem.W_SE
    mode2: bool = False       # propagate the deformation to untracked
                              # in-frustum landmarks (the reference's mode-2
                              # path, Optimizer.cc:812-828 / FEA2 Compute(2))
    mode2_cap: int = 1024     # untracked landmark capacity for mode 2


def _gather_problem(cam: Camera, cfg: TrackConfig, nr: NRConfig,
                    state: MapState, frame: Frame):
    """Build the BA problem: camera 0 = the frame (free), cameras 1.. = the
    keyframes that observe most of its landmarks (fixed); points = the
    frame's tracked landmarks, free (reference Optimizer.cc:500-709).
    Returns (prob, rows, lm_ids, row_ok)."""
    dev = state.device
    pid = frame.point_ids
    okp = (pid >= 0) & frame.valid
    P_cap = nr.pts_cap
    # padding slots alias row 0 (which may itself be live): padding is
    # marked by position, never by looking up okp
    rows, row_ok = scatter.nonzero_static(okp, P_cap)
    lm_ids = torch.where(row_ok, pid[rows], 0)
    # which keyframes observe these landmarks: vote, take the top n_fixed_kfs
    marker = scatter.scatter_max(state.P, lm_ids, row_ok.to(_I32), 0)
    kp_bound = state.kf_kp_valid & (state.kf_kp_point >= 0)
    hits = marker[torch.where(kp_bound, state.kf_kp_point, 0).long()] \
        * kp_bound
    votes = hits.sum(1) * state.kf_valid
    # most votes tie at 0: the stable top_k keeps the lower slot first
    top_v, top_kf = top_k(votes, nr.n_fixed_kfs)
    kf_ok = top_v > 0

    # observations from the frame (camera 0)
    ar = torch.arange(P_cap, dtype=_I32, device=dev)
    inv_sig_f = scale_invsigma2(frame.octave[rows], cfg.scale_factor)
    o1_cam = torch.zeros((P_cap,), dtype=_I32, device=dev)

    # observations from the fixed keyframes
    p_row = scatter.scatter_max(state.P, lm_ids,
                                torch.where(row_ok, ar, INVALID), INVALID)
    kp_pt = state.kf_kp_point[top_kf]                          # (Nk, F)
    kp_ok = state.kf_kp_valid[top_kf] & (kp_pt >= 0) & kf_ok[:, None]
    prow = p_row[torch.clamp(kp_pt, min=0).long()]
    flat_ok = (kp_ok & (prow >= 0)).reshape(-1)
    sel, live = scatter.nonzero_static(flat_ok, nr.obs_cap - P_cap)
    o2_cam = (sel // state.F + 1).to(_I32)
    o2_pt = prow.reshape(-1)[sel]
    o2_uvr = state.kf_kp_uvr[top_kf].reshape(-1, 3)[sel]
    o2_sig = scale_invsigma2(state.kf_kp_octave[top_kf].reshape(-1)[sel],
                             cfg.scale_factor)

    cam_free = torch.zeros((1 + nr.n_fixed_kfs,), dtype=torch.bool,
                           device=dev)
    cam_free[0] = True
    prob = ba.BAProblem(
        cam_pose7=torch.cat([frame.pose7[None], state.kf_pose7[top_kf]]),
        cam_free=cam_free,
        points=state.lm_xyz[lm_ids.long()],
        point_valid=row_ok,
        obs_cam=torch.cat([o1_cam, o2_cam]),
        obs_point=torch.cat([ar, torch.where(live, o2_pt, 0)]),
        obs_uvr=torch.cat([frame.uvr[rows], o2_uvr]),
        obs_inv_sigma2=torch.cat([inv_sig_f, o2_sig]),
        obs_valid=torch.cat([row_ok, live]),
    )
    return prob, rows, lm_ids, row_ok


def _ba_solve_nr(cam: Camera, prob: ba.BAProblem, mesh: fem.FemMesh,
                 parent_map, w_se):
    """Strain-energy-augmented BA: 10 + 10 LM iterations, the element
    stiffness computed once per call."""
    ke_all = fem.element_stiffness_batch(mesh)

    def extra_cost(pts):
        node_pos = fem.node_positions(mesh, pts[parent_map])
        return w_se * fem.strain_energy(mesh, ke_all, node_pos)

    return ba.ba_solve(cam, prob, iters_phase1=10, iters_phase2=10,
                       extra_cost_fn=extra_cost)


def _mode2_solve(mesh: fem.FemMesh, d_pin, fixed):
    """Mode-2 elastic propagation: element stiffness, b = -K d_pin, and the
    constrained Jacobi-CG equilibrium."""
    ke_all = fem.element_stiffness_batch(mesh)
    b = -fem.stiffness_matvec(mesh, ke_all, d_pin)
    return fem.solve_displacement(mesh, ke_all, b, fixed, iters=64)


def _project_points(cam: Camera, pose7, pts):
    R, t = lie.pose7_unpack(pose7)
    return cam_ops.project(cam, lie.se3_apply(R, t, pts))


def pose_optimization_nr(cam: Camera, cfg: TrackConfig, nr: NRConfig,
                         state: MapState, frame: Frame,
                         return_prop: bool = False):
    """Run the FEM-regularized pose + points optimization.

    Gathers the problem, reads points, mask and projections once for the
    host mesher, builds the mesh, runs the strain-augmented BA and reads the
    inlier count. Returns (frame', state', n_good, ok); with
    return_prop=True a 5th element carries the mode-2 propagation closure
    (or None), so that the caller can put off the propagation to the
    untracked landmarks until the non-rigid result wins its stage."""
    failed = ((frame, state, 0, False, None) if return_prop
              else (frame, state, 0, False))
    prob, rows, lm_ids, row_ok = _gather_problem(cam, cfg, nr, state, frame)
    uv_d = _project_points(cam, frame.pose7, prob.points)[0]
    # ONE packed device -> host read for everything the mesher needs
    packed = torch.cat([prob.points, uv_d, row_ok.to(uv_d.dtype)[:, None]],
                       1).cpu().numpy()
    pts_np, uv_np, ok_np = packed[:, :3], packed[:, 3:5], packed[:, 5] > 0
    if int(ok_np.sum()) < 12:
        return failed
    idx_real = np.where(ok_np)[0]
    mesh = fem.build_mesh(pts_np[idx_real], uv_np[idx_real],
                          el_type=nr.el_type, max_nodes=nr.mesh_nodes,
                          max_elems=nr.mesh_elems, device=state.device)
    if mesh is None:
        return failed
    # mesh parent indices (into idx_real's order) -> problem point rows
    pm = np.zeros((nr.pts_cap,), np.int64)
    pm[:len(idx_real)] = idx_real
    parent_map = torch.from_numpy(pm).to(state.device)

    res = _ba_solve_nr(cam, prob, mesh, parent_map, nr.w_se)
    inl = res.obs_inlier[:nr.pts_cap]
    n_good = int(inl.sum())              # the attempt's second, last read
    # write back: the frame pose and the moved landmarks; the frame's
    # OUTLIER associations are unbound, so that the widened projection
    # searches that follow can rebind those features (the reference nulls
    # mvbOutlier entries after each dual stage, Tracking.cc:1990-1993). The
    # reference sends the rows it keeps to the out-of-range row F and drops
    # them; the mask does the same here.
    frame = frame._replace(
        pose7=res.cam_pose7[0],
        point_ids=scatter.masked_set(frame.point_ids, rows, row_ok & ~inl,
                                     INVALID))
    state = state._replace(
        lm_xyz=scatter.masked_set(state.lm_xyz, lm_ids, row_ok, res.points),
        lm_rigid=scatter.masked_set(state.lm_rigid, lm_ids, row_ok, 2))
    prop = None
    if nr.mode2:
        f_cap, s_cap = frame, state
        new_np = res.points.cpu().numpy()

        def prop(st=s_cap):
            return propagate_untracked(cam, nr, st, f_cap, lm_ids, row_ok,
                                       pts_np, new_np)
        if not return_prop:
            state = prop()
            prop = None
    if return_prop:
        return frame, state, n_good, True, prop
    return frame, state, n_good, True


def propagate_untracked(cam: Camera, nr: NRConfig, state: MapState,
                        frame: Frame, lm_ids, row_ok,
                        old_pts: np.ndarray, new_pts: np.ndarray):
    """Mode-2 deformation propagation (reference FEA2::Compute(2) +
    ComputeNewDisplacement, FEA2.cc:1914-1917; caller Optimizer.cc:812-828):
    the untracked landmarks in the frustum join the tracked set in one mesh;
    the tracked nodes' displacements (from the non-rigid optimization) are
    Dirichlet data, and the elastic equilibrium K a = 0 under those
    constraints moves the untracked nodes. The set algebra is host work."""
    uv_all, z_all = _project_points(cam, frame.pose7, state.lm_xyz)
    # two packed reads: the landmark pool's floats, the tracked rows' ints
    pool = torch.cat([uv_all, z_all[:, None], state.lm_xyz,
                      state.lm_valid.to(z_all.dtype)[:, None]],
                     1).cpu().numpy()
    uv_np, z_np, lm_xyz_np, lmv_np = (pool[:, :2], pool[:, 2], pool[:, 3:6],
                                      pool[:, 6] > 0)
    tracked = torch.stack([lm_ids.long(), row_ok.long()]).cpu().numpy()
    ok_np = tracked[1] > 0
    tracked_ids = tracked[0][ok_np]
    d_tracked = (new_pts - old_pts)[ok_np]                 # (Nt, 3)
    # untracked in-frustum landmarks
    W, H = float(cam.width), float(cam.height)
    in_img = ((z_np > 0.05) & (uv_np[:, 0] >= 0) & (uv_np[:, 0] < W)
              & (uv_np[:, 1] >= 0) & (uv_np[:, 1] < H))
    untracked = lmv_np & in_img
    untracked[tracked_ids] = False
    un_ids = np.where(untracked)[0]
    if len(un_ids) > nr.mode2_cap:
        # keep the untracked landmarks NEAREST the tracked surface: those
        # the elastic propagation means something for
        tracked_xyz = np.ascontiguousarray(old_pts[ok_np], np.float32)
        un_xyz = lm_xyz_np[un_ids].astype(np.float32)
        span = float(np.ptp(tracked_xyz, axis=0).max()) + 1e-6
        nb = geometry.knn(tracked_xyz, un_xyz, k=1, cell=span / 8)
        safe = np.clip(nb[:, 0], 0, len(tracked_xyz) - 1)
        d = np.linalg.norm(un_xyz - tracked_xyz[safe], axis=1)
        d[nb[:, 0] < 0] = np.inf
        un_ids = un_ids[np.argsort(d)[:nr.mode2_cap]]
    if len(un_ids) < 4:
        return state
    union_ids = np.concatenate([tracked_ids, un_ids])
    pts_u = lm_xyz_np[union_ids].copy()
    pts_u[:len(tracked_ids)] = old_pts[ok_np]   # mesh in the REFERENCE config
    mesh = fem.build_mesh(pts_u, uv_np[union_ids], el_type=1,
                          max_nodes=2 * nr.mesh_nodes,
                          max_elems=2 * nr.mesh_elems, device=state.device)
    if mesh is None:
        return state
    M = mesh.u0.shape[0]
    half = M // 2
    n_union = len(union_ids)
    n_tracked = len(tracked_ids)
    # BOTH layers of the tracked columns are pinned at the tracked
    # displacement (the reference's Set_uf moves layer 2 rigidly with layer
    # 1, FEA2.cc:1732-1796; pinning layer 2 at zero would shear the tracked
    # columns and flip the sign of the propagated field); both layers of
    # the untracked columns are free.
    fixed = np.ones((M,), bool)
    fixed[n_tracked:n_union] = False
    fixed[half + n_tracked:half + n_union] = False
    d_pin = np.zeros((M, 3), np.float32)
    d_pin[:n_tracked] = d_tracked
    d_pin[half:half + n_tracked] = d_tracked
    dev = state.device
    a = _mode2_solve(mesh, torch.from_numpy(d_pin).to(dev),
                     torch.from_numpy(fixed).to(dev))
    un = torch.from_numpy(un_ids).to(dev)
    lm_xyz = state.lm_xyz.clone()
    lm_xyz[un] = lm_xyz[un] + a[n_tracked:n_union]
    lm_rigid = state.lm_rigid.clone()
    lm_rigid[un] = 2
    return state._replace(lm_xyz=lm_xyz, lm_rigid=lm_rigid)


def set_rigidity_flags(state: MapState, frame: Frame,
                       rigid: bool) -> MapState:
    """Tag the frame's tracked landmarks rigid (1) or non-rigid (2)
    (reference Tracking::SetRigidityFlag, src/Tracking.cc:2242-2268)."""
    pid = frame.point_ids
    okp = (pid >= 0) & frame.valid
    return state._replace(
        lm_rigid=scatter.masked_set(state.lm_rigid, pid, okp,
                                    1 if rigid else 2))
