"""System facade for the RGB-D main path.

Port of `orb_slam2_e_tpu/models/system.py` for `Sensor.RGBD` on the
synchronous frame loop (reference System::TrackRGBD): per frame, ORB
extraction + depth lookup + frame build, the fused tracking step with one
host read of its packed flags, the keyframe policy, and keyframe insertion
followed by one mapping pass.

What this port refuses, with NotImplementedError naming the ROADMAP item:
monocular and stereo sensors, loop closing, the deformable mode, the
pipelined loop, the relocalization KPI protocol, localization-only mode,
and a LOST frame that would need relocalization.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from ..ops import lie
from ..ops.camera import Camera
from ..ops.orb import OrbExtractor
from .frame import Frame, frame_from_features, sample_depth_at
from .map_state import MapState, INVALID
from . import tracking as T
from . import local_mapping as LM


class TrackState(enum.Enum):
    """Reference Tracking::eTrackingState."""
    SYSTEM_NOT_READY = -1
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


@dataclasses.dataclass
class SystemConfig:
    """The reference's SystemConfig fields and defaults; the RGB-D slice
    reads the tracking and mapping ones and refuses the options it does not
    port (see `SlamSystem`)."""
    max_keyframes: int = 256
    max_points: int = 24576
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    th_depth: float = 35.0
    depth_map_factor: float = 1.0
    deformable: bool = False
    el_type: int = 1
    loop_closing: bool = True
    reloc_test_all_frames: bool = False
    n_precision_frames: int = 2
    stats_reloc_path: str = None
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 30
    min_init_matches: int = 100
    min_init_points: int = 80
    local_ba: bool = True
    mapping: bool = True
    pipeline: bool = True
    vocab_path: str = None


_REFUSED = (
    ("loop_closing", True, "loop closing (ROADMAP Q1 #14)"),
    ("deformable", True, "the deformable FEM mode (ROADMAP Q1 #15)"),
    ("pipeline", True, "the pipelined frame loop (ROADMAP Q1 #8: the "
                       "synchronous loop is the port's)"),
    ("reloc_test_all_frames", True, "the relocalization KPI protocol "
                                    "(ROADMAP Q1 #13)"),
    ("mapping", False, "localization-only mode (ROADMAP Q1 #13)"),
)


class SlamSystem:
    """RGB-D SLAM facade. Typical use:

        sys = SlamSystem(cam, SystemConfig(pipeline=False,
                                           loop_closing=False),
                         Sensor.RGBD, device="cuda")
        for im, depth, ts in frames:
            pose = sys.track_rgbd(im, depth, ts)   # (R, t) Tcw or None
        sys.save_trajectory_tum("traj.txt")
    """

    def __init__(self, cam: Camera, cfg: SystemConfig = SystemConfig(),
                 sensor: Sensor = Sensor.MONOCULAR, *, device):
        if sensor != Sensor.RGBD:
            raise NotImplementedError(
                f"{sensor.name} is not ported yet (ROADMAP Q1 #9 mono, "
                "#11 stereo); the port runs Sensor.RGBD")
        for field, refused, what in _REFUSED:
            if getattr(cfg, field) == refused:
                raise NotImplementedError(
                    f"SystemConfig({field}={refused}): {what} is not ported")
        self.device = torch.device(device)
        self.cam = cam.to(self.device)
        self.cfg = cfg
        self.sensor = sensor
        self.extractor = OrbExtractor(
            cfg.n_features, cfg.scale_factor, cfg.n_levels,
            cfg.ini_th_fast, cfg.min_th_fast)
        self.track_cfg = T.TrackConfig(
            scale_factor=cfg.scale_factor, n_levels=cfg.n_levels,
            th_depth=cfg.th_depth)
        dflt = LM.MappingConfig()
        self.map_cfg = LM.MappingConfig(
            scale_factor=cfg.scale_factor, n_levels=cfg.n_levels,
            n_neighbors=min(dflt.n_neighbors, cfg.max_keyframes),
            ba_cams=min(dflt.ba_cams, cfg.max_keyframes),
            ba_fixed=min(dflt.ba_fixed, cfg.max_keyframes),
            ba_points=min(dflt.ba_points, cfg.max_points),
            ba_obs=min(dflt.ba_obs, 3 * cfg.max_points))
        self.reset()

    # ------------------------------------------------------------------ state
    def reset(self):
        """Reference System::Reset -> Tracking::Reset."""
        self.map = MapState.create(self.cfg.max_keyframes,
                                   self.extractor.capacity,
                                   self.cfg.max_points, device=self.device)
        self.state = TrackState.NO_IMAGES_YET
        self.last_frame: Optional[Frame] = None
        self.velocity7: Optional[torch.Tensor] = None
        self.frame_id = -1
        self.last_kf_slot = -1
        self.last_kf_frame_id = -1
        self.last_reloc_frame_id = -10 ** 9
        self._ref_matches = 0
        self.n_keyframes = 0
        self.trajectory = []      # (timestamp, pose7 tensor or None)
        self.stats = {"kf_inserted": 0, "points_created": 0,
                      "points_culled": 0, "kf_culled": 0,
                      "capacity_clips": 0, "clip_bits": 0}

    def get_tracking_state(self) -> TrackState:
        return self.state

    # ------------------------------------------------------------ main entry
    def track_rgbd(self, image, depth, timestamp: float):
        """Reference System::TrackRGBD. image: (H, W) grey (uint8 or
        float32), depth: (H, W) raw depth (times depth_map_factor = m)."""
        image = torch.as_tensor(image, device=self.device)
        depth = torch.as_tensor(depth, device=self.device)
        return self._track(image, depth, timestamp)

    # ------------------------------------------------------------- internals
    def _make_frame(self, image, depth_map) -> Frame:
        feats = self.extractor(image)
        d = sample_depth_at(depth_map, feats.uv, self.cfg.depth_map_factor)
        return frame_from_features(self.cam, feats, d)

    def _track(self, image, depth, timestamp: float):
        self.frame_id += 1
        if self.state == TrackState.NO_IMAGES_YET:
            self.state = TrackState.NOT_INITIALIZED
        if self.state == TrackState.NOT_INITIALIZED:
            frame = self._make_frame(image, depth)
            ok = self._initialize_depth(frame, timestamp)
            self._record(timestamp, self.last_frame if ok else None)
            if not ok:
                self.last_frame = frame
            return self._last_pose() if ok else None
        return self._track_sync(image, depth, timestamp)

    def _track_step(self, frame: Frame):
        """The fused tracking step and its one host read. Returns (frame,
        velocity7', [ok, n_inliers, ref_matches, clipped])."""
        have_vel = self.velocity7 is not None
        vel = self.velocity7 if have_vel else lie.pose7_identity(
            device=self.device)
        self.map, frame, vel_new, flags = T.track_frame_fused(
            self.cam, self.track_cfg, self.map, frame, self.last_frame,
            vel, have_vel, max(self.last_kf_slot, 0))
        return frame, vel_new, flags.tolist()

    def _track_sync(self, image, depth, timestamp: float):
        """One tracking step + ONE packed device->host read per frame; the
        host makes the state-machine decisions with current-frame truth."""
        if self.state == TrackState.LOST:
            raise NotImplementedError(
                "tracking is LOST and relocalization is not ported "
                "(ROADMAP Q1 #12-#13: BoW + PnP relocalization)")
        frame = self._make_frame(image, depth)
        frame, vel_new, flags = self._track_step(frame)
        ok, n_in, self._ref_matches, clipped = (bool(flags[0]), flags[1],
                                                flags[2], flags[3])
        if clipped:                       # local-map search hit its capacity
            self.stats["capacity_clips"] += 1
            self.stats["clip_bits"] |= 1 << 4
        if not ok:
            was_ok = self.state == TrackState.OK
            self.state = TrackState.LOST
            self.velocity7 = None
            if was_ok and self.n_keyframes <= 5:
                self.reset()              # lost right after init: restart
            self._record(timestamp, None)
            self.last_frame = frame
            return None
        self.state = TrackState.OK
        self.velocity7 = vel_new
        if self._need_new_keyframe(n_in):
            self._insert_keyframe(frame, timestamp)
        self._record(timestamp, frame)
        self.last_frame = frame
        return self._last_pose()

    def _initialize_depth(self, frame: Frame, timestamp: float) -> bool:
        """RGB-D initialization: the first frame with >= 200 features with
        depth becomes KF0 and spawns landmarks (reference
        Tracking::StereoInitialization)."""
        if int((frame.valid & (frame.depth > 0)).sum()) < 200:
            return False
        slot = int(self.map.free_kf_slot())
        self.map, frame = T.insert_keyframe(
            self.cam, self.track_cfg, self.map, frame, self.frame_id,
            timestamp, INVALID, slot)
        self.state = TrackState.OK
        self.last_kf_slot = slot
        self.last_kf_frame_id = self.frame_id
        self.n_keyframes = 1
        self.last_frame = frame
        self.stats["kf_inserted"] += 1
        return True

    def _need_new_keyframe(self, n_inliers: int) -> bool:
        """Reference Tracking::NeedNewKeyFrame: c1a = too long since the
        last KF; c1b = min gap passed; c2 = tracking weak vs the reference
        KF but alive."""
        if self.n_keyframes >= self.cfg.max_keyframes - 2:
            return False
        if (self.frame_id < self.last_reloc_frame_id
                + self.cfg.max_frames_between_kf
                and self.n_keyframes > self.cfg.max_frames_between_kf):
            return False
        frames_since = self.frame_id - self.last_kf_frame_id
        c1a = frames_since >= self.cfg.max_frames_between_kf
        c1b = frames_since >= self.cfg.min_frames_between_kf
        c2 = (n_inliers < self._ref_matches * 0.9) and n_inliers > 15
        return (c1a or c1b) and c2

    def _insert_keyframe(self, frame: Frame, timestamp: float):
        """Keyframe insertion + one mapping pass, one packed host read. As
        in the reference, the caller keeps its pre-insertion frame."""
        slot = int(self.map.free_kf_slot())
        if slot < 0:                      # no free keyframe slot
            return
        n_after = self.n_keyframes + 1
        st, _ = T.insert_keyframe(
            self.cam, self.track_cfg, self.map, frame, self.frame_id,
            timestamp, self.last_kf_slot, slot)
        self.map, (n_culled, n_new, victims, clipped) = LM.mapping_pass(
            self.cam, self.map_cfg, st, slot,
            do_ba=self.cfg.local_ba and n_after > 2,
            do_cull_kf=n_after > 4)
        packed = torch.cat([torch.stack([n_culled, n_new, clipped]).to(
            torch.int64), victims.to(torch.int64)]).tolist()
        n_culled, n_new, clipped = packed[:3]
        if clipped:
            self.stats["capacity_clips"] += 1
            self.stats["clip_bits"] |= clipped
        self.last_kf_slot = slot
        self.last_kf_frame_id = self.frame_id
        self.n_keyframes += 1
        self.stats["kf_inserted"] += 1
        for victim in packed[3:]:
            if victim >= 0:
                self.n_keyframes -= 1
                self.stats["kf_culled"] += 1
        self.stats["points_created"] += n_new
        self.stats["points_culled"] += n_culled

    # ------------------------------------------------------------ trajectory
    def _record(self, timestamp, frame):
        self.trajectory.append(
            (timestamp, frame.pose7.clone() if frame is not None else None))

    def _last_pose(self):
        p7 = self.trajectory[-1][1]
        if p7 is None:
            return None
        return lie.pose7_unpack(p7)

    def get_trajectory(self):
        """-> (timestamps, R_wc (N,3,3), t_wc (N,3)) numpy, tracked frames."""
        ts = [tstamp for tstamp, p7 in self.trajectory if p7 is not None]
        p7s = [p7 for _, p7 in self.trajectory if p7 is not None]
        if not p7s:
            return np.zeros((0,)), np.zeros((0, 3, 3)), np.zeros((0, 3))
        R, t = lie.pose7_unpack(torch.stack(p7s))
        Rwc, twc = lie.se3_inverse(R, t)
        return np.asarray(ts), Rwc.cpu().numpy(), twc.cpu().numpy()

    def save_trajectory_tum(self, path):
        """Reference System::SaveTrajectoryTUM."""
        from ..utils import trajectory as traj
        ts, R, t = self.get_trajectory()
        traj.save_tum(path, ts, R, t)

    def save_keyframe_trajectory_tum(self, path):
        """Reference System::SaveKeyFrameTrajectoryTUM."""
        from ..utils import trajectory as traj
        kf_ok = self.map.kf_valid
        R, t = lie.pose7_unpack(self.map.kf_pose7[kf_ok])
        Rwc, twc = lie.se3_inverse(R, t)
        traj.save_tum(path, self.map.kf_timestamp[kf_ok].cpu().numpy(),
                      Rwc.cpu().numpy(), twc.cpu().numpy())

    def get_tracked_map_points(self):
        """Landmark ids bound in the last frame (reference
        System::GetTrackedMapPoints)."""
        if self.last_frame is None:
            return np.zeros((0,), np.int32)
        pid = self.last_frame.point_ids.cpu().numpy()
        return pid[pid >= 0]
