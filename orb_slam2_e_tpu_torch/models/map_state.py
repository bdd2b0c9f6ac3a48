"""The map as a fixed-capacity structure of arrays.

Port of `orb_slam2_e_tpu/models/map_state.py` with the same field names,
shapes and dtypes, so a map carries across between the packages field by
field (`utils/convert.py`). Every update returns a new MapState; the tensors
of the old one are not written.

Divergence from the reference: `covisibility_row` marks the keyframe's
landmarks with a max-scatter. The reference uses `.set`, where masked rows
write 0 into slot 0 beside a real write of 1 there, in an unspecified order
(the aliasing fault `ops/scatter.py` warns about), so landmark 0 may drop
out of its counts. The port counts what the code means.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INVALID = -1

_I32 = torch.int32


class MapState(NamedTuple):
    # --- keyframe pool ---
    kf_pose7: torch.Tensor     # (K, 7) Tcw as [qw qx qy qz t]
    kf_valid: torch.Tensor     # (K,) bool
    kf_frame_id: torch.Tensor  # (K,) int32
    kf_timestamp: torch.Tensor # (K,) float32
    kf_kp_uvr: torch.Tensor    # (K, F, 3)
    kf_kp_octave: torch.Tensor # (K, F) int32
    kf_kp_angle: torch.Tensor  # (K, F) float32
    kf_kp_valid: torch.Tensor  # (K, F) bool
    kf_desc: torch.Tensor      # (K, F, 32) uint8
    kf_kp_point: torch.Tensor  # (K, F) int32 landmark id or -1
    kf_parent: torch.Tensor    # (K,) int32 spanning-tree parent (-1 root)
    kf_loop_edge: torch.Tensor # (K, 4) int32
    kf_seq: torch.Tensor       # (K,) int32 monotone insertion sequence id
    next_seq: torch.Tensor     # () int32
    # --- landmark pool ---
    lm_xyz: torch.Tensor       # (P, 3)
    lm_valid: torch.Tensor     # (P,) bool
    lm_desc: torch.Tensor      # (P, 32) uint8
    lm_angle: torch.Tensor     # (P,) float32
    lm_normal: torch.Tensor    # (P, 3)
    lm_min_dist: torch.Tensor  # (P,)
    lm_max_dist: torch.Tensor  # (P,)
    lm_ref_kf: torch.Tensor    # (P,) int32
    lm_first_seq: torch.Tensor # (P,) int32 birth keyframe sequence id
    lm_visible: torch.Tensor   # (P,) float32
    lm_found: torch.Tensor     # (P,) float32
    lm_rigid: torch.Tensor     # (P,) int8

    @property
    def K(self):
        return self.kf_pose7.shape[0]

    @property
    def F(self):
        return self.kf_kp_uvr.shape[1]

    @property
    def P(self):
        return self.lm_xyz.shape[0]

    @property
    def device(self):
        return self.kf_pose7.device

    @staticmethod
    def create(max_keyframes: int = 256, max_features: int = 1024,
               max_points: int = 32768, *, device,
               dtype=torch.float32) -> "MapState":
        K, F, P = max_keyframes, max_features, max_points

        def z(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        def full(shape, v, dt=_I32):
            return torch.full(shape, v, dtype=dt, device=device)

        pose = z((K, 7))
        pose[:, 0] = 1.0
        return MapState(
            kf_pose7=pose, kf_valid=z((K,), torch.bool),
            kf_frame_id=full((K,), INVALID), kf_timestamp=z((K,)),
            kf_kp_uvr=z((K, F, 3)), kf_kp_octave=z((K, F), _I32),
            kf_kp_angle=z((K, F)), kf_kp_valid=z((K, F), torch.bool),
            kf_desc=z((K, F, 32), torch.uint8),
            kf_kp_point=full((K, F), INVALID), kf_parent=full((K,), INVALID),
            kf_loop_edge=full((K, 4), INVALID), kf_seq=full((K,), INVALID),
            next_seq=full((), 0),
            lm_xyz=z((P, 3)), lm_valid=z((P,), torch.bool),
            lm_desc=z((P, 32), torch.uint8), lm_angle=z((P,)),
            lm_normal=z((P, 3)), lm_min_dist=z((P,)), lm_max_dist=z((P,)),
            lm_ref_kf=full((P,), INVALID), lm_first_seq=full((P,), INVALID),
            lm_visible=torch.ones((P,), dtype=dtype, device=device),
            lm_found=torch.ones((P,), dtype=dtype, device=device),
            lm_rigid=z((P,), torch.int8))

    # ---- derived quantities ----

    def n_keyframes(self):
        return self.kf_valid.sum()

    def n_points(self):
        return self.lm_valid.sum()

    def observation_counts(self) -> torch.Tensor:
        """(P,) int32 number of keyframes observing each landmark."""
        pt = torch.where(self.kf_kp_valid & self.kf_valid[:, None],
                         self.kf_kp_point, INVALID).reshape(-1)
        ok = pt >= 0
        return torch.zeros((self.P,), dtype=_I32, device=self.device) \
            .scatter_add(0, torch.where(ok, pt, 0).long(), ok.to(_I32))

    def covisibility_row(self, kf) -> torch.Tensor:
        """(K,) int32 shared-observation counts between keyframe `kf` (an
        int or an integer tensor; a tensor is not read by the host) and all
        keyframes (reference KeyFrame::UpdateConnections weights)."""
        k1 = torch.as_tensor(kf, device=self.device).reshape(1).long()
        my_pts = self.kf_kp_point.index_select(0, k1)[0]
        my_mask = (my_pts >= 0) & self.kf_kp_valid.index_select(0, k1)[0]
        marker = torch.zeros((self.P,), dtype=_I32, device=self.device) \
            .scatter_reduce(0, torch.where(my_mask, my_pts, 0).long(),
                            my_mask.to(_I32), reduce="amax")
        ok = (self.kf_kp_point >= 0) & self.kf_kp_valid
        other = torch.where(ok, self.kf_kp_point, 0).long()
        hits = marker[other] * ok
        row = (hits.sum(1) * self.kf_valid).to(_I32)
        return row.index_fill(0, k1, 0)

    def covisibility_matrix(self) -> torch.Tensor:
        """(K, K) int32 covisibility weights, W = A A^T over the (K, P)
        keyframe-landmark incidence A, with a zero diagonal. A is float32
        (CUDA has no integer matmul): counts below 2^24 are exact. The
        incidence is a max-scatter, here as in the reference, so a masked
        feature (which aliases landmark 0) never clears a real observation
        of landmark 0."""
        obs_ok = ((self.kf_kp_point >= 0) & self.kf_kp_valid
                  & self.kf_valid[:, None])
        pid = torch.where(obs_ok, self.kf_kp_point, 0).long()
        A = torch.zeros((self.K, self.P), dtype=torch.float32,
                        device=self.device)
        A.scatter_reduce_(1, pid, obs_ok.to(torch.float32), reduce="amax")
        W = (A @ A.T).to(_I32)
        return W * (1 - torch.eye(self.K, dtype=_I32, device=self.device))

    # ---- functional updates ----

    def add_keyframe(self, slot, pose7, frame_id, timestamp, kp_uvr,
                     kp_octave, kp_angle, kp_valid, desc, kp_point,
                     parent=INVALID) -> "MapState":
        """Write a keyframe into `slot` (reference KeyFrame ctor +
        Map::AddKeyFrame)."""
        def put(arr, val):
            out = arr.clone()
            out[slot] = val
            return out

        return self._replace(
            kf_pose7=put(self.kf_pose7, pose7),
            kf_valid=put(self.kf_valid, True),
            kf_frame_id=put(self.kf_frame_id, frame_id),
            kf_timestamp=put(self.kf_timestamp, timestamp),
            kf_kp_uvr=put(self.kf_kp_uvr, kp_uvr),
            kf_kp_octave=put(self.kf_kp_octave, kp_octave),
            kf_kp_angle=put(self.kf_kp_angle, kp_angle),
            kf_kp_valid=put(self.kf_kp_valid, kp_valid),
            kf_desc=put(self.kf_desc, desc),
            kf_kp_point=put(self.kf_kp_point, kp_point),
            kf_parent=put(self.kf_parent, parent),
            kf_seq=put(self.kf_seq, self.next_seq),
            next_seq=self.next_seq + 1,
        )

    def remove_keyframe(self, slot) -> "MapState":
        """Cull a keyframe: free the slot, detach its observations."""
        kf_valid = self.kf_valid.clone()
        kf_kp_valid = self.kf_kp_valid.clone()
        kf_kp_point = self.kf_kp_point.clone()
        kf_valid[slot] = False
        kf_kp_valid[slot] = False
        kf_kp_point[slot] = INVALID
        return self._replace(kf_valid=kf_valid, kf_kp_valid=kf_kp_valid,
                             kf_kp_point=kf_kp_point)

    def remove_points(self, dead_mask: torch.Tensor) -> "MapState":
        """Invalidate landmarks in `dead_mask` (P,) and detach every
        keyframe reference to them."""
        pt = self.kf_kp_point
        is_dead = (pt >= 0) & dead_mask[torch.where(pt >= 0, pt, 0).long()]
        return self._replace(
            lm_valid=self.lm_valid & ~dead_mask,
            kf_kp_point=torch.where(is_dead, INVALID, pt))

    def allocate_points(self, want_mask: torch.Tensor):
        """Assign free landmark slots to each True entry of want_mask (N,)
        by prefix-sum compaction over the free list. Returns (slots (N,)
        int32, INVALID where none, ok_mask (N,) bool)."""
        P = self.P
        dev = self.device
        free = ~self.lm_valid
        free_rank = torch.cumsum(free.to(_I32), 0) - 1
        slot_of_rank = torch.full((P,), INVALID, dtype=_I32, device=dev) \
            .scatter_reduce(
                0, torch.where(free, free_rank, P - 1).long(),
                torch.where(free, torch.arange(P, dtype=_I32, device=dev),
                            INVALID),
                reduce="amax")
        want_rank = torch.cumsum(want_mask.to(_I32), 0) - 1
        n_free = free.to(_I32).sum()
        ok = want_mask & (want_rank < n_free)
        slots = torch.where(
            ok, slot_of_rank[torch.clamp(want_rank, 0, P - 1).long()],
            INVALID).to(_I32)
        return slots, ok

    def free_kf_slot(self) -> torch.Tensor:
        """Lowest invalid keyframe slot id (or -1 if full), 0-d int32."""
        free = ~self.kf_valid
        idx = torch.argmax(free.to(_I32))
        return torch.where(free.any(), idx, INVALID).to(_I32)
