"""Batched multi-sequence tracking: B independent camera streams tracked in
lock step, each op of a step launched once for all lanes.

Port of `orb_slam2_e_tpu/parallel/batched.py`. The reference vmaps its whole
per-frame program (extraction, frame, `track_frame_fused`) over the lanes
under one `jit`. Here the extraction of all lanes is one call of
`OrbExtractor.extract_batch` (one launch of the FAST/NMS/blur kernel over
the B pyramids while B x n_levels <= 64, the kernel's level table; one per
group of 64 // n_levels lanes beyond) and the rest, the frame and `track_frame_fused`, runs under
`torch.vmap` over the lanes: every torch op of the step is issued once with
a lane dimension. A ctypes launch cannot be vmapped, hence the split. The
state (the per-lane maps, last frames, velocities) stays on the device and
nothing is read by the host inside a step.
"""

from __future__ import annotations

import torch

from ..models import tracking as T
from ..models.frame import Frame, frame_from_features
from ..ops import lie
from ..ops.camera import Camera
from ..ops.orb import OrbExtractor
from ..utils.convert import stack_lanes


class BatchedTracker:
    """Lock-step tracker over B sequences against per-lane maps
    (localization mode: no keyframe insertion inside the batch loop)."""

    def __init__(self, cam: Camera, cfg: T.TrackConfig, map_states,
                 n_features: int = 1000, scale_factor: float = 1.2,
                 n_levels: int = 8, device=None):
        self.device = torch.device("cuda" if device is None else device)
        self.cam = cam.to(self.device)
        self.cfg = cfg
        self.extractor = OrbExtractor(n_features, scale_factor, n_levels)
        # the per-lane maps as one MapState of (B, ...) tensors
        self.state = stack_lanes([type(m)(*(v.to(self.device) for v in m))
                                  for m in map_states])
        self.B = len(map_states)
        self.last_frames = None
        self.vels = lie.pose7_identity(device=self.device).expand(
            self.B, 7).clone()
        self.have_vel = torch.zeros((self.B,), dtype=torch.bool,
                                    device=self.device)
        self._lanes = torch.vmap(self._lane)

    def _lane(self, state, feats, last, vel, have_vel, ref_kf):
        frame = frame_from_features(self.cam, feats)
        return T.track_frame_fused(self.cam, self.cfg, state, frame, last,
                                   vel, have_vel, ref_kf)

    def bootstrap(self, frames):
        """Provide initial per-lane frames (e.g. from the map-building run)."""
        self.last_frames = stack_lanes([Frame(*(v.to(self.device) for v in f))
                                        for f in frames])

    def step(self, images, ref_kfs):
        """images: (B, H, W) uint8 or float32; ref_kfs: (B,) int. Returns
        (ok (B,) bool, n_inliers (B,) int32), on the device."""
        feats = self.extractor.extract_batch(
            torch.as_tensor(images, device=self.device))
        ref_kfs = torch.as_tensor(ref_kfs, device=self.device)
        state, frames, vels, flags = self._lanes(
            self.state, feats, self.last_frames, self.vels, self.have_vel,
            ref_kfs)
        self.state = state
        self.vels = vels                        # computed on the device
        ok = flags[:, 0].to(torch.bool)
        self.have_vel = ok
        self.last_frames = frames
        return ok, flags[:, 1]
