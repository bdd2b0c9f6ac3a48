"""Per-frame feature record (functional Frame).

Port of `orb_slam2_e_tpu/models/frame.py`: ORB features, undistorted
keypoints, RGB-D pseudo-stereo right coordinates, and the frame's landmark
associations `point_ids`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import camera as cam_ops
from ..ops.camera import Camera
from ..ops.orb import OrbFeatures

INVALID = -1


class Frame(NamedTuple):
    pose7: torch.Tensor      # (7,) Tcw
    uvr: torch.Tensor        # (F, 3) undistorted u, v, u_right (<0 => mono)
    uv_raw: torch.Tensor     # (F, 2) raw (distorted) pixel coords
    octave: torch.Tensor     # (F,) int32
    angle: torch.Tensor      # (F,)
    response: torch.Tensor   # (F,)
    desc: torch.Tensor       # (F, 32) uint8
    valid: torch.Tensor      # (F,) bool
    point_ids: torch.Tensor  # (F,) int32 landmark id or -1
    depth: torch.Tensor      # (F,) z depth (<=0 => unknown)

    @property
    def F(self):
        return self.uvr.shape[0]


def scale_invsigma2(octave: torch.Tensor, scale_factor: float):
    """1 / sigma^2(octave): information weights (reference
    mvInvLevelSigma2)."""
    sigma2 = scale_factor ** (2.0 * octave.to(torch.float32))
    return 1.0 / sigma2


def frame_from_features(cam: Camera, feats: OrbFeatures,
                        depth_lookup=None) -> Frame:
    """Build a Frame from extractor output; with depths, ur = u - bf/d."""
    uv_und = cam_ops.undistort_pixels(cam, feats.uv)
    n = feats.uv.shape[0]
    dev = feats.uv.device
    if depth_lookup is None:
        ur = torch.full((n,), -1.0, device=dev)
        depth = torch.full((n,), -1.0, device=dev)
    else:
        depth = depth_lookup
        ok = depth > 0
        ur = torch.where(
            ok, uv_und[:, 0] - cam.bf / torch.where(ok, depth,
                                                    torch.ones_like(depth)),
            torch.full_like(depth, -1.0))
    uvr = torch.cat([uv_und, ur[:, None]], dim=-1)
    pose7 = torch.zeros((7,), dtype=uvr.dtype, device=dev)
    pose7[0] = 1.0
    return Frame(
        pose7=pose7, uvr=uvr, uv_raw=feats.uv, octave=feats.octave,
        angle=feats.angle, response=feats.response, desc=feats.desc,
        valid=feats.valid,
        point_ids=torch.full((n,), INVALID, dtype=torch.int32, device=dev),
        depth=depth)


def compact_frame(frame: Frame, priority: torch.Tensor, out_cap: int):
    """Select `out_cap` features of a larger frame: priority rows first,
    then the highest response (the monocular initializer's 2x-budget frames
    reduced to the map's feature capacity). The key stays f32 and the sort
    stable and descending, so ties fall as in `jnp.argsort(-key)`.

    Returns (frame_out (out_cap rows), sel (out_cap,) source rows,
    inv (F_in,) source row -> output row or -1)."""
    F_in = frame.F
    key = priority.to(torch.float32) * 1e6 + frame.response.to(torch.float32)
    key = torch.where(frame.valid, key, torch.full_like(key, -1.0))
    order = torch.argsort(-key, stable=True)
    sel = order[:out_cap]
    inv = torch.full((F_in,), INVALID, dtype=torch.int32, device=key.device)
    inv[sel] = torch.arange(out_cap, dtype=torch.int32, device=key.device)
    out = Frame(pose7=frame.pose7, **{
        k: getattr(frame, k)[sel] for k in Frame._fields if k != "pose7"})
    return out, sel, inv


def sample_depth_at(depth_map: torch.Tensor, uv: torch.Tensor,
                    depth_factor: float = 1.0,
                    edge_rel_tol: float = 0.08) -> torch.Tensor:
    """Nearest-neighbour depth at raw keypoint coords; rejected (-1) where
    the valid depths of the 3x3 neighbourhood spread by more than
    `edge_rel_tol` (a sample across a depth edge is wrong by meters)."""
    H, W = depth_map.shape
    x = torch.clamp(torch.round(uv[:, 0]), 0, W - 1).to(torch.int64)
    y = torch.clamp(torch.round(uv[:, 1]), 0, H - 1).to(torch.int64)
    dm = depth_map.to(torch.float32)
    d = dm[y, x] * depth_factor
    offs = torch.tensor([-1, 0, 1], device=uv.device)
    yy = torch.clamp(y[:, None, None] + offs[None, :, None], 0, H - 1)
    xx = torch.clamp(x[:, None, None] + offs[None, None, :], 0, W - 1)
    nb = dm.reshape(-1)[(yy * W + xx).reshape(len(x), 9)] * depth_factor
    nb_valid = nb > 0
    inf = torch.full_like(nb, float("inf"))
    nb_min = torch.amin(torch.where(nb_valid, nb, inf), dim=1)
    nb_max = torch.amax(torch.where(nb_valid, nb, -inf), dim=1)
    flat = (nb_max - nb_min) <= edge_rel_tol * torch.clamp(nb_min, min=1e-6)
    return torch.where((d > 0) & flat, d, torch.full_like(d, -1.0))
