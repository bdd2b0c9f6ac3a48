"""System facade: the public SLAM entry point.

Port of `orb_slam2_e_tpu/models/system.py` (reference System::Track
{Monocular,Stereo,RGBD}): per frame, ORB extraction and the frame build
(depth lookup, or the stereo matcher, or nothing for mono), the tracking
step, the keyframe policy, and keyframe insertion followed by one mapping
pass. Mono bootstraps from two frames (`tracking.mono_init_*`); stereo and
RGB-D from one. A LOST frame, on any sensor, is relocalized through BoW
candidates, PnP RANSAC and the rigid S1/S2/S3 ladder, and the relocalization
KPI protocol (`reloc_test_all_frames`) is supported.

Behind every inserted keyframe the loop closer runs (`loop_closing`, on by
default): a BoW candidate query whose result is read when the next keyframe
arrives, the covisibility-group consistency check, Sim3 RANSAC and
refinement, the verification ladder, the loop correction with the
essential-graph optimization, loop fusion, and a global BA on a snapshot of
the map, run in chunks (one behind each tracked frame) and merged back.

In the deformable mode (`SystemConfig(deformable=True)`) every stage of the
relocalization ladder runs the rigid pose optimization and the
FEM-regularized non-rigid one (`models/deformable.py`) side by side on the
same matches, and an accepted non-rigid relocalization commits the deformed
landmarks to the map. `save_map` / `load_map` write and read the map, the
counters of the run and the vocabulary as one npz file (`utils/map_io.py`),
in the reference's format.

In localization-only mode (`SystemConfig(mapping=False)` or
`activate_localization_mode()`) tracking never changes the map: frames are
tracked against it, with temporary visual-odometry points where the camera
leaves it and relocalization beside them. With `deformable=False` nothing
changes the map there. With `deformable=True` an accepted non-rigid
relocalization still moves the landmarks it tracked and sets their
`lm_rigid`, as in the reference: that is what the mode is for.

The frame loop is the reference's. With `SystemConfig(pipeline=True)`, the
default, a tracked frame runs the pipelined loop (`_track_pipelined`): the
super-step tracks the frame against a loop state kept on the device
(`_LoopState`), makes the keyframe decision there, and inserts the keyframe
and runs its mapping pass at once, carrying the post-insertion frame
forward. The host reads one packed predicate per frame, to decide whether
to queue the insertion; the frame's flags come back through pinned memory
and are read every other frame (`_drain_pending`), so the host's state
machine, the recognition database, the loop closer and the KPI counters
run up to two frames behind, as in the reference. `pipeline=False`,
`reloc_test_all_frames` and localization-only mode run the synchronous
loop (`_track_sync`): one packed read per frame and every decision on the
current frame's flags.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import ba as ba_ops
from ..ops import bow, lie, matching
from ..ops import stereo as stereo_ops
from ..ops.camera import Camera
from ..ops.orb import OrbExtractor
from ..utils import map_io
from ..utils.config import Settings
from ..utils.stats import RELOC_COLUMNS, RelocKpi, Statistics
from .frame import Frame, frame_from_features, sample_depth_at
from .map_state import MapState, INVALID
from . import deformable as DEF
from . import kf_database as KFDB
from . import local_mapping as LM
from . import loop_closing as LC
from . import relocalization as RELOC
from . import tracking as T

# the vocabulary bundled with the reference package, read by path (the
# port never imports `orb_slam2_e_tpu`)
BUNDLED_VOCAB = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "orb_slam2_e_tpu", "assets",
    "vocab.npz")


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
    """The reference's SystemConfig fields and defaults."""
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
    reloc_test_all_frames: bool = False  # force a relocalization attempt
                                         # after every TP (KPI protocol)
    n_precision_frames: int = 2
    stats_reloc_path: str = None         # per-attempt StatsReloc rows
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 30
    min_init_matches: int = 100
    min_init_points: int = 80
    local_ba: bool = True
    mapping: bool = True
    pipeline: bool = True                # the pipelined frame loop; the
                                         # KPI protocol and localization-only
                                         # mode run the synchronous one
    vocab_path: str = None               # None: the bundled vocabulary

    @staticmethod
    def from_settings(s: Settings, vocab_path: str = None) -> "SystemConfig":
        return SystemConfig(
            n_features=s.orb.n_features, scale_factor=s.orb.scale_factor,
            n_levels=s.orb.n_levels, ini_th_fast=s.orb.ini_th_fast,
            min_th_fast=s.orb.min_th_fast, th_depth=s.th_depth,
            # reference Tracking.cc:172-175: mDepthMapFactor = 1/factor and
            # the RAW depth image is multiplied by it (GrabImageRGBD). The
            # config stores the MULTIPLIER for raw depth values; track_rgbd
            # expects raw (e.g. uint16, 5000 per metre) depth maps.
            depth_map_factor=(1.0 if abs(s.depth_map_factor) < 1e-5
                              or abs(s.depth_map_factor - 1.0) < 1e-5
                              else 1.0 / s.depth_map_factor),
            max_frames_between_kf=int(s.fps),
            el_type=s.reloc.el_type,
            reloc_test_all_frames=s.reloc.test_all_frames,
            n_precision_frames=s.reloc.n_precision_frames,
            stats_reloc_path=s.stats_reloc,
            vocab_path=vocab_path)


class _LoopState(NamedTuple):
    """What the pipelined loop tracks the next frame with, on the system's
    device, so that the host never reads it before the next dispatch."""
    map: MapState
    last_frame: Frame
    vel7: torch.Tensor            # (7,) motion model
    vel_ok: torch.Tensor          # () bool
    ref_kf: torch.Tensor          # () int32 reference keyframe slot
    last_kf_fid: torch.Tensor     # () int32 frame id of the last keyframe
    last_reloc_fid: torch.Tensor  # () int32 frame id of the last reloc


def keyframe_policy(ok, n_in, ref_matches, nkf, frame_id, last_kf_fid,
                    last_reloc_fid, mapping_on, *, max_keyframes: int,
                    max_frames: int, min_frames: int) -> torch.Tensor:
    """The pipelined loop's keyframe decision on the device, elementwise
    over broadcastable tensors (reference `_super`, the rules of
    `SlamSystem._need_new_keyframe` with `nkf` counted on the device and
    c2 in float32): room in the map, no relocalization in the last
    `max_frames` frames once the map holds more keyframes than that, c1a
    (too long since the last keyframe) or c1b (the min gap passed), and c2
    (tracking weak against the reference keyframe but alive)."""
    frames_since = frame_id - last_kf_fid
    room = nkf < max_keyframes - 2
    recent_block = (frame_id < last_reloc_fid + max_frames) & (
        nkf > max_frames)
    c1a = frames_since >= max_frames
    c1b = frames_since >= min_frames
    c2 = (n_in.to(torch.float32) < 0.9 * ref_matches.to(torch.float32)) & (
        n_in > 15)
    return mapping_on & ok & room & ~recent_block & (c1a | c1b) & c2


class SlamSystem:
    """SLAM facade. Typical use:

        sys = SlamSystem(cam, SystemConfig(), Sensor.MONOCULAR,
                         device="cuda", seed=0)
        for im, ts in frames:
            pose = sys.track_monocular(im, ts)   # (R, t) Tcw or None
        sys.shutdown()                # finishes a pending global BA
        sys.save_trajectory_tum("traj.txt")

    `seed` seeds the system's `torch.Generator` (on `device`), which draws
    every RANSAC sample, as the reference's `jax.random.PRNGKey(seed)`.
    """

    def __init__(self, cam: Camera, cfg: SystemConfig = SystemConfig(),
                 sensor: Sensor = Sensor.MONOCULAR, *, device,
                 seed: int = 0):
        self.device = torch.device(device)
        self.cam = cam.to(self.device)
        self.cfg = cfg
        self.sensor = sensor
        self.extractor = OrbExtractor(
            cfg.n_features, cfg.scale_factor, cfg.n_levels,
            cfg.ini_th_fast, cfg.min_th_fast)
        # mono initialization extracts a doubled feature budget (reference
        # Tracking.cc:131-134); the init frames are compacted back to the
        # map's capacity on success
        self.init_extractor = (
            OrbExtractor(2 * cfg.n_features, cfg.scale_factor, cfg.n_levels,
                         cfg.ini_th_fast, cfg.min_th_fast)
            if sensor == Sensor.MONOCULAR else self.extractor)
        # the right image's extractor: the left one's capacity and pyramid
        # with the extractor's default FAST thresholds, as the reference's
        # stereo_depth_for_features builds it
        self.right_extractor = (
            OrbExtractor(self.extractor.capacity, cfg.scale_factor,
                         cfg.n_levels)
            if sensor == Sensor.STEREO else None)
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
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.reset()

    # chunked global BA: 5 chunks x 2 LM iterations = the reference's 10
    GBA_CHUNKS = 5
    GBA_ITERS_PER_CHUNK = 2
    GBA_CG_ITERS = 50

    # ------------------------------------------------------------------ state
    def reset(self):
        """Reference System::Reset -> Tracking::Reset."""
        self.map = MapState.create(self.cfg.max_keyframes,
                                   self.extractor.capacity,
                                   self.cfg.max_points, device=self.device)
        self.state = TrackState.NO_IMAGES_YET
        self.last_frame: Optional[Frame] = None
        self.init_frame: Optional[Frame] = None
        self.init_ts = 0.0
        self.velocity7: Optional[torch.Tensor] = None
        self.frame_id = -1
        self.last_kf_slot = -1
        self.last_kf_frame_id = -1
        self.last_reloc_frame_id = -10 ** 9
        self._ref_matches = 0
        self._loop_state = None     # the pipelined loop's device state
        self._pending = []          # its frames whose flags are not read
        self._loop_pending = None   # loop-candidate query not yet read
        self._gba = None            # pending chunked global BA
        self._reset_gen = getattr(self, "_reset_gen", 0) + 1
        self.n_keyframes = 0
        self.trajectory = []      # (timestamp, pose7 tensor or None)
        self.localization_only = not self.cfg.mapping
        self.vo_mode = False      # reference Tracking::mbVO
        # clip_bits: 0 BA points, 1 fixed ring, 2 BA obs, 3 fuse, 4 local-map
        # search, 5 GBA obs, 6 essential-graph edges, 7 verify_sim3 loop
        # group, 8 loop search_and_fuse
        self.stats = {"kf_inserted": 0, "points_created": 0,
                      "points_culled": 0, "kf_culled": 0, "relocs": 0,
                      "loops_closed": 0, "capacity_clips": 0, "clip_bits": 0}
        self.loop_detector = LC.LoopDetector()
        self.last_loop_kf = -1000
        self._last_loop_kf_count = 0
        # place recognition: the pretrained vocabulary when there is one,
        # else one trained from the first keyframes (`_ensure_vocab`)
        self.vocab = None
        self.bow_db = None
        self._load_pretrained_vocab()
        self.kpi = RelocKpi(self.cfg.n_precision_frames)
        self.reloc_stats = (Statistics(self.cfg.stats_reloc_path,
                                       RELOC_COLUMNS)
                            if self.cfg.stats_reloc_path else None)

    def activate_localization_mode(self):
        """Reference System::ActivateLocalizationMode."""
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False

    def get_tracking_state(self) -> TrackState:
        return self.state

    # ------------------------------------------------------------ main entry
    def _as_image(self, image) -> torch.Tensor:
        return torch.as_tensor(image, device=self.device)

    def track_monocular(self, image, timestamp: float):
        """Reference System::TrackMonocular. image: (H, W) grey."""
        assert self.sensor == Sensor.MONOCULAR
        return self._track((self._as_image(image),), timestamp)

    def track_rgbd(self, image, depth, timestamp: float):
        """Reference System::TrackRGBD. image: (H, W) grey (uint8 or
        float32), depth: (H, W) raw depth (times depth_map_factor = m)."""
        assert self.sensor == Sensor.RGBD
        return self._track((self._as_image(image), self._as_image(depth)),
                           timestamp)

    def track_stereo(self, image_left, image_right, timestamp: float):
        """Reference System::TrackStereo: depth from the stereo matcher on a
        rectified pair."""
        assert self.sensor == Sensor.STEREO
        return self._track((self._as_image(image_left),
                            self._as_image(image_right)), timestamp)

    # ------------------------------------------------------------- internals
    def _make_frame_inputs(self, inputs) -> Frame:
        """ORB extraction and the frame build for this sensor."""
        if self.sensor == Sensor.STEREO:
            img_l, img_r = inputs
            feats = self.extractor(img_l)
            depth = stereo_ops.stereo_depth_for_features(
                self.cam, img_l, img_r, feats, self.cfg.scale_factor,
                self.right_extractor)
            return frame_from_features(self.cam, feats, depth)
        if self.sensor == Sensor.RGBD:
            feats = self.extractor(inputs[0])
            d = sample_depth_at(inputs[1], feats.uv,
                                self.cfg.depth_map_factor)
            return frame_from_features(self.cam, feats, d)
        ex = (self.init_extractor if self.state == TrackState.NOT_INITIALIZED
              else self.extractor)
        return frame_from_features(self.cam, ex(inputs[0]))

    def _track(self, inputs: tuple, timestamp: float):
        self.frame_id += 1
        if self.state == TrackState.NO_IMAGES_YET:
            self.state = TrackState.NOT_INITIALIZED
        if self.state == TrackState.NOT_INITIALIZED:
            frame = self._make_frame_inputs(inputs)
            ok = self._initialize(frame, timestamp)
            # on success _initialize stored the (compacted) last_frame
            self._record(timestamp, self.last_frame if ok else None)
            if ok:
                self._seed_loop_state(self.last_frame)
            else:
                self.last_frame = frame
            return self._last_pose() if ok else None
        if self.pipelined:
            return self._track_pipelined(inputs, timestamp)
        return self._track_sync(inputs, timestamp)

    @property
    def pipelined(self) -> bool:
        """Whether a tracked frame runs the pipelined loop: the reference's
        rule, `pipeline` unless the KPI protocol (which needs the state
        machine on the current frame) or localization-only mode (which
        arbitrates VO and relocalization on the host)."""
        return (self.cfg.pipeline and not self.cfg.reloc_test_all_frames
                and not self.localization_only)

    def _track_step(self, frame: Frame):
        """The tracking step, not yet read by the host. Returns (frame,
        velocity7', flags tensor): [ok, n_inliers, ref_matches, clipped],
        and in localization-only mode also [vo, n_total_mm]; there the
        step tracks with temporary VO points and leaves the map as it is
        (reference "Localization Mode", Tracking.cc:395-485)."""
        have_vel = self.velocity7 is not None
        vel = self.velocity7 if have_vel else lie.pose7_identity(
            device=self.device)
        args = (self.cam, self.track_cfg, self.map, frame, self.last_frame,
                vel, have_vel, max(self.last_kf_slot, 0))
        if self.localization_only:
            return T.track_frame_loc(*args)
        self.map, frame, vel_new, flags = T.track_frame_fused(*args)
        return frame, vel_new, flags

    def _track_sync(self, inputs: tuple, timestamp: float):
        """One tracking step and ONE packed device->host read per frame;
        the host makes the state-machine decisions with current-frame
        truth (reference Tracking::Track)."""
        if self.last_frame is None:
            # no previous frame to track against: relocalize directly
            frame, ok = self._relocalize(self._make_frame_inputs(inputs))
            self.last_frame = frame
            if ok:
                self.state = TrackState.OK
                self.velocity7 = None
                self.kpi.on_frame_tracked(self.frame_id)
                self._record(timestamp, frame)
                return self._last_pose()
            self.state = TrackState.LOST
            self.kpi.on_frame_lost(self.frame_id)
            self._record(timestamp, None)
            return None
        loc = self.localization_only
        frame, vel_new, flags = self._track_step(
            self._make_frame_inputs(inputs))
        # one bounded chunk of a pending global BA rides the queue behind
        # this frame's step: the copy of the flags is queued first and the
        # host waits for that copy alone, not for the chunk queued after it
        flags, copied = self._to_host(flags)
        self._advance_gba()
        if copied is not None:
            copied.synchronize()
        flags = flags.tolist()            # the frame's one host read
        ok, n_in, self._ref_matches, clipped = (bool(flags[0]), flags[1],
                                                flags[2], flags[3])
        if clipped:                       # local-map search hit its capacity
            self.stats["capacity_clips"] += 1
            self.stats["clip_bits"] |= 1 << 4
        vo = loc and bool(flags[4])
        self.vo_mode = vo
        relocalized = False
        if self.state == TrackState.LOST:
            # once lost, only relocalization rescues (reference
            # Tracking.cc:392)
            frame, ok = self._relocalize(frame)
            relocalized = ok
        elif vo:
            # VO mode: the motion-model and the relocalization solution
            # side by side; relocalization wins when it succeeds
            # (reference Tracking.cc:425-465)
            frame_r, rok = self._relocalize(frame)
            if rok:
                frame, ok, relocalized = frame_r, True, True
                self.vo_mode = False
        if not ok:
            was_ok = self.state == TrackState.OK
            self.state = TrackState.LOST
            self.velocity7 = None
            self.kpi.on_frame_lost(self.frame_id)
            if was_ok and self.n_keyframes <= 5 \
                    and not self.localization_only:
                self.reset()              # lost right after init: restart
            self._record(timestamp, None)
            self.last_frame = frame
            return None
        tp = self.kpi.on_frame_tracked(self.frame_id)
        self.state = TrackState.OK
        # after a relocalization the step's velocity came from the failed
        # pose: drop it and let the motion model rebuild
        self.velocity7 = None if relocalized else vel_new
        if self.cfg.reloc_test_all_frames and tp:
            # KPI protocol: a TP was just registered; force LOST so the next
            # frame relocalizes again (reference Tracking.cc:497-501)
            self.state = TrackState.LOST
            self.velocity7 = None
            self._record(timestamp, None)
            self.last_frame = frame
            return None
        if not self.localization_only and self._need_new_keyframe(n_in):
            self._insert_keyframe(frame, timestamp)
        self._record(timestamp, frame)
        self.last_frame = frame
        return self._last_pose()

    # ------------------------------------------------- pipelined frame loop
    def _seed_loop_state(self, frame: Frame):
        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=self.device)
        self._loop_state = _LoopState(
            map=self.map, last_frame=frame,
            vel7=lie.pose7_identity(device=self.device),
            vel_ok=torch.tensor(False, device=self.device),
            ref_kf=i32(max(self.last_kf_slot, 0)),
            last_kf_fid=i32(self.last_kf_frame_id),
            last_reloc_fid=i32(max(self.last_reloc_frame_id, -10 ** 9)))
        self._pending = []

    def _sstep(self, loop: _LoopState, inputs: tuple, frame_id: int,
               timestamp: float, mapping_on: bool):
        """The super-step of one frame (the reference's `_sstep_mono`,
        `_sstep_depth` and `_sstep_stereo`, whose sensor front ends are
        `_make_frame_inputs`)."""
        return self._super(loop, self._make_frame_inputs(inputs), frame_id,
                           timestamp, mapping_on)

    def _super(self, loop: _LoopState, frame: Frame, frame_id: int,
               timestamp: float, mapping_on: bool):
        """Tracking, the keyframe decision on the device, and insertion with
        a mapping pass when it says so. The host reads ONE packed predicate
        [need_kf, slot, do_ba, do_cull_kf] to decide whether to queue the
        insertion (the reference's `lax.cond`; `need_kf` with no free slot
        skips, as the reference's select leaves the map and frame as they
        were). Returns (loop state', flags, pose): flags = [ok, n_in,
        ref_matches, clip_track, slot, n_culled, n_new, victim0, victim1,
        clip_map, inserted] int32, not read; pose a fresh tensor for the
        trajectory."""
        cfg = self.cfg
        ref_kf = loop.ref_kf.clamp(min=0)
        m1, f_out, vel_new, flags4 = T.track_frame_fused(
            self.cam, self.track_cfg, loop.map, frame, loop.last_frame,
            loop.vel7, loop.vel_ok, ref_kf)
        ok = flags4[0] > 0
        nkf = m1.kf_valid.sum().to(torch.int32)
        need_kf = keyframe_policy(
            ok, flags4[1], flags4[2], nkf, frame_id, loop.last_kf_fid,
            loop.last_reloc_fid, mapping_on,
            max_keyframes=cfg.max_keyframes,
            max_frames=cfg.max_frames_between_kf,
            min_frames=cfg.min_frames_between_kf)
        slot = m1.free_kf_slot()
        do_ba = (nkf + 1 > 2) & cfg.local_ba
        do_cull_kf = nkf + 1 > 4
        pred = torch.stack([need_kf.to(torch.int32), slot,
                            do_ba.to(torch.int32),
                            do_cull_kf.to(torch.int32)]).cpu()
        if bool(pred[0]) and int(pred[1]) >= 0:
            m2, f2, packed = self._super_insert(
                m1, f_out, frame_id, timestamp, ref_kf, int(pred[1]),
                pred[2].bool(), pred[3].bool())
        else:
            m2, f2 = m1, f_out
            packed = torch.tensor([INVALID, 0, 0, INVALID, INVALID, 0],
                                  dtype=torch.int32, device=self.device)
        inserted = need_kf & (slot >= 0)
        loop2 = _LoopState(
            map=m2, last_frame=f2, vel7=vel_new, vel_ok=ok,
            ref_kf=torch.where(inserted, slot, loop.ref_kf),
            last_kf_fid=torch.where(inserted, frame_id, loop.last_kf_fid),
            last_reloc_fid=loop.last_reloc_fid)
        flags = torch.cat([flags4.to(torch.int32), packed,
                           inserted.to(torch.int32)[None]])
        return loop2, flags, f2.pose7.clone()

    def _super_insert(self, state: MapState, frame: Frame, frame_id: int,
                      timestamp: float, parent, slot: int, do_ba, do_cull_kf):
        """The super-step's insertion: the keyframe into `slot` under
        `parent`, then one mapping pass (`do_ba` / `do_cull_kf` 0-d bool
        tensors on the host). Returns (map, post-insertion frame, [slot,
        n_culled, n_new, victim0, victim1, clip_map] int32)."""
        st1, fr1 = T.insert_keyframe(self.cam, self.track_cfg, state, frame,
                                     frame_id, timestamp, parent, slot)
        st2, (n_culled, n_new, victims, clipped) = LM.mapping_pass_dyn(
            self.cam, self.map_cfg, st1, slot, do_ba, do_cull_kf)
        packed = torch.stack([torch.as_tensor(v, device=self.device).to(
            torch.int32) for v in (slot, n_culled, n_new, *victims,
                                   clipped)])
        return st2, fr1, packed

    def _track_pipelined(self, inputs: tuple, timestamp: float):
        """Queue the frame's super-step, then read earlier frames' flags:
        every other frame, the two pending ones (`_drain_pending`), so the
        host's decisions run up to two frames behind. The step gates
        itself (a failed frame inserts nothing); frames queued after a
        failure track against the reference keyframe. A LOST system drains
        and, still LOST, relocalizes this frame on the host."""
        if self.state == TrackState.LOST:
            self._drain_pending()
            if self.state == TrackState.LOST:
                frame, ok = self._relocalize(self._make_frame_inputs(inputs))
                if ok:
                    # as the reference: no KPI call for this frame
                    self.state = TrackState.OK
                    self.last_frame = frame
                    if self._loop_state is None:
                        self._seed_loop_state(frame)
                    self._loop_state = self._loop_state._replace(
                        map=self.map, last_frame=frame,
                        vel_ok=torch.tensor(False, device=self.device),
                        last_reloc_fid=torch.tensor(
                            self.frame_id, dtype=torch.int32,
                            device=self.device))
                    self._record(timestamp, frame)
                    return self._last_pose()
                self.kpi.on_frame_lost(self.frame_id)
                if self.n_keyframes <= 5 and not self.localization_only:
                    self.reset()
                self._record(timestamp, None)
                return None
        if self._loop_state is None:
            self._seed_loop_state(self.last_frame)
        self._loop_state, flags, pose = self._sstep(
            self._loop_state, inputs, self.frame_id, timestamp,
            not self.localization_only)
        self.map = self._loop_state.map
        self.last_frame = self._loop_state.last_frame
        # the flags' copy is queued before a global-BA chunk, so that
        # reading them never waits for the chunk
        flags = self._to_host(flags)
        self._advance_gba()
        if len(self._pending) >= 2:
            self._drain_pending()
        if self._loop_state is None:
            # a reset in the drain: this frame's step is void
            self._record(timestamp, None)
            return None
        self.trajectory.append((timestamp, pose))
        self._pending.append((self.frame_id, flags,
                              len(self.trajectory) - 1))
        return self._last_pose()

    def _to_host(self, t: torch.Tensor):
        """(tensor, event): a CUDA tensor copied to pinned host memory
        behind the queued work, with the event that marks the copy done;
        a CPU tensor as it is, with None."""
        if t.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _drain_pending(self):
        """Read and act on the flags of every pending frame, oldest first.
        A reset on the way (lost right after initialization) voids the
        rest."""
        while self._pending:
            gen = self._reset_gen
            items, self._pending = self._pending, []
            for fid, (host, done), tidx in items:
                if done is not None:
                    done.synchronize()
                self._process_flags(fid, host.tolist(), tidx)
                if self._reset_gen != gen:
                    return

    def _process_flags(self, fid: int, flags: list, tidx: int):
        """The host's bookkeeping of one frame of the pipelined loop,
        arriving up to two frames late: state, KPI, the counters of an
        inserted keyframe, recognition database upkeep and loop closing.
        A not-ok frame's trajectory entry is revoked."""
        self._count_clip(flags[3] << 4)   # local-map search hit its capacity
        if not flags[0]:
            self.trajectory[tidx] = (self.trajectory[tidx][0], None)
            was_ok = self.state == TrackState.OK
            self.state = TrackState.LOST
            self.kpi.on_frame_lost(fid)
            if was_ok and self.n_keyframes <= 5 \
                    and not self.localization_only:
                self.reset()
            return
        self.kpi.on_frame_tracked(fid)
        self.state = TrackState.OK
        slot, n_culled, n_new, victim0, victim1, clip_map = flags[4:10]
        if not (flags[10] and slot >= 0):
            return
        self.last_kf_slot = slot
        self.last_kf_frame_id = fid
        self.n_keyframes += 1
        self.stats["kf_inserted"] += 1
        self.stats["points_created"] += n_new
        self.stats["points_culled"] += n_culled
        self._count_clip(clip_map)
        for victim in (victim0, victim1):
            if victim >= 0:
                if self.bow_db is not None:
                    self.bow_db = self.bow_db.erase(victim)
                self.n_keyframes -= 1
                self.stats["kf_culled"] += 1
        self._ensure_vocab()
        self._db_add(slot)
        if self.cfg.loop_closing:
            self._try_close_loop(slot)
            if self._loop_state is not None:
                self._loop_state = self._loop_state._replace(map=self.map)

    def _initialize(self, frame: Frame, timestamp: float) -> bool:
        if self.sensor in (Sensor.RGBD, Sensor.STEREO):
            return self._initialize_depth(frame, timestamp)
        # monocular two-frame bootstrap (reference Tracking.cc:681-934)
        m = self.cfg.min_init_matches
        n_valid = int(frame.valid.sum())
        if self.init_frame is None or n_valid < m:
            self.init_frame = frame if n_valid >= m else None
            self.init_ts = timestamp
            return False
        midx, n_m = T.mono_init_match(self.track_cfg, self.init_frame, frame)
        if int(n_m) < m:
            self.init_frame = frame       # slide the reference forward
            self.init_ts = timestamp
            return False
        # reduce the 2x-budget init frames to map capacity (matched first)
        f_ref_c, f_cur_c, midx_c = T.mono_init_compact(
            self.init_frame, frame, midx, self.extractor.capacity)
        new_map, new_frame, success, n_good = T.mono_init_reconstruct(
            self.gen, self.cam, self.track_cfg, self.map, f_ref_c, f_cur_c,
            midx_c, self.init_ts, timestamp, m)
        success, n_good = torch.stack([success.to(torch.int64),
                                       n_good.to(torch.int64)]).tolist()
        if not success:
            return False
        # refine the initial map with a small BA (reference
        # GlobalBundleAdjustemnt(20), Tracking.cc:873)
        self.map, _, _ = LM.local_ba(self.cam, self.map_cfg, new_map, 1)
        self.state = TrackState.OK
        self.last_kf_slot = 1
        self.last_kf_frame_id = self.frame_id
        self.n_keyframes = 2
        self.velocity7 = None
        self.last_frame = new_frame._replace(pose7=self.map.kf_pose7[1])
        self.stats["kf_inserted"] += 2
        self.stats["points_created"] += n_good
        return True

    def _initialize_depth(self, frame: Frame, timestamp: float) -> bool:
        """Stereo/RGB-D initialization: the first frame with >= 200
        features with depth becomes KF0 and spawns landmarks (reference
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
        KF but alive. A fresh relocalization blocks insertion for
        max_frames_between_kf frames once the map is large enough."""
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
        """Keyframe insertion + one mapping pass, one packed host read, then
        the place-recognition upkeep. As in the reference, the caller keeps
        its pre-insertion frame."""
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
                if self.bow_db is not None:
                    self.bow_db = self.bow_db.erase(victim)
                self.n_keyframes -= 1
                self.stats["kf_culled"] += 1
        self.stats["points_created"] += n_new
        self.stats["points_culled"] += n_culled
        self._ensure_vocab()
        self._db_add(slot)
        if self.cfg.loop_closing:
            self._try_close_loop(slot)

    # ------------------------------------------------- place recognition
    def _load_pretrained_vocab(self):
        """Load the vocabulary npz (SystemConfig.vocab_path, else the one
        bundled with the reference package); the reference loads ORBvoc
        in the System constructor (System.cc:69-76)."""
        path = self.cfg.vocab_path
        if path is None and os.path.exists(BUNDLED_VOCAB):
            path = BUNDLED_VOCAB
        if path is None:
            return
        voc = bow.load_vocabulary(path, device=self.device)
        if voc is not None:
            self._set_vocab(voc)

    def _set_vocab(self, voc: bow.Vocabulary):
        self.vocab = voc
        self.bow_db = KFDB.BowDatabase.create(
            self.cfg.max_keyframes, voc.n_words, device=self.device)

    def _ensure_vocab(self):
        """Without a pretrained vocabulary: train one from the keyframes'
        descriptors once there are enough, and backfill the database."""
        if self.vocab is not None or self.n_keyframes < 4:
            return
        kf_ok = self.map.kf_valid.cpu().numpy()
        desc = self.map.kf_desc.cpu().numpy()[kf_ok]
        kp_ok = self.map.kf_kp_valid.cpu().numpy()[kf_ok]
        corpus = desc.reshape(-1, 32)[kp_ok.reshape(-1)]
        if len(corpus) < 2000:
            return
        self._set_vocab(bow.train_vocabulary(corpus, k=10, L=3, iters=4,
                                             device=self.device))
        for slot in np.where(kf_ok)[0]:
            self._db_add(int(slot))

    def _bow_vec(self, desc, valid):
        return bow.bow_vector(self.vocab,
                              bow.transform(self.vocab, desc, valid)[0],
                              valid)

    def _db_add(self, slot: int):
        if self.vocab is None:
            return
        vec = self._bow_vec(self.map.kf_desc[slot],
                            self.map.kf_kp_valid[slot])
        self.bow_db = self.bow_db.add(slot, vec)

    # ------------------------------------------------- relocalization
    def _dual_optimize(self, work_map: MapState, frame: Frame, stage: int,
                       th: int):
        """One stage of the dual rigid / non-rigid optimization (reference
        Tracking.cc:1951-2107): PoseOptimization and, in the deformable
        mode, PoseOptimizationNR side by side on the SAME matches and pose,
        then the reference's decision table

            nGoodR <  th and nGoodNR <  th -> fail (keep going wider)
            nGoodR >= th and nGoodNR <  th -> rigid pose
            nGoodNR >= th                  -> non-rigid pose (map deforms)

        with th = 10 for S1/S2 and 50 for S3. The non-rigid branch runs
        whenever a pose estimate exists, not only when the rigid one
        succeeded, so it can rescue a rigid failure on a deformed map.
        Outside the deformable mode its columns of the stats row read -1
        and 0.0.

        `work_map` is the attempt's WORKING map: when the non-rigid branch
        wins a stage its deformed landmarks are carried into the next
        stage's projection search; the system's map changes only when the
        attempt is accepted. The mode-2 propagation to the untracked
        landmarks is put off until the branch has won.

        Returns (work_map, frame, n_good, used_nr), n_good = 0 below th."""
        st = self.reloc_stats
        t0 = time.perf_counter()
        frame_r, n_r = RELOC.optimize_frame_pose(self.cam, self.track_cfg,
                                                 work_map, frame)
        n_r = int(n_r)
        t_r = time.perf_counter() - t0
        n_nr, map_nr, frame_nr, t_nr, prop_nr = -1, None, None, 0.0, None
        if self.cfg.deformable:
            nr_cfg = DEF.NRConfig(el_type=self.cfg.el_type,
                                  pts_cap=self.extractor.capacity,
                                  mode2=True)
            t1 = time.perf_counter()
            # from the pre-rigid pose and the full match set (the reference
            # restores mTcwBackup before PoseOptimizationNR)
            frame_nr, map_nr, n_nr, ran, prop_nr = DEF.pose_optimization_nr(
                self.cam, self.track_cfg, nr_cfg, work_map, frame,
                return_prop=True)
            t_nr = time.perf_counter() - t1
            if not ran:
                n_nr = -1
        if st:
            st.add(f"nGoodR_S{stage}", n_r)
            st.add(f"timeR_S{stage}", round(t_r, 6))
            st.add(f"nGoodNR_S{stage}", n_nr)
            st.add(f"timeNR_S{stage}", round(t_nr, 6))
        if n_nr >= th:
            if prop_nr is not None:
                map_nr = prop_nr(map_nr)
            return map_nr, frame_nr, n_nr, True
        if n_r >= th:
            return work_map, frame_r, n_r, False
        # both failed: keep the non-rigid frame and map when they did
        # better (the reference's mCurrentFrame holds the NR pose and its
        # map the moved points after the dual run), so that the next,
        # wider stage searches from them
        if n_nr > n_r and frame_nr is not None:
            if prop_nr is not None:
                map_nr = prop_nr(map_nr)
            return map_nr, frame_nr, 0, False
        return work_map, frame_r, 0, False

    def _relocalize(self, frame: Frame):
        """Reference Tracking::Relocalization: BoW candidates -> PnP
        RANSAC per candidate -> full-map projection (>= 12 matches) -> the
        S1/S2/S3 ladder, each stage a dual optimization, accepted at
        RELOC_GOOD. Each attempt logs a StatsReloc row. Returns
        (frame, ok)."""
        self._ensure_vocab()
        if self.vocab is None:
            return frame, False
        st = self.reloc_stats
        q = self._bow_vec(frame.desc, frame.valid)
        cand, scores = KFDB.detect_relocalization_candidates(self.bow_db, q)
        cand_ok = scores > 0
        n_cand = int(cand_ok.sum())
        if st:
            st.add("Frame", self.frame_id)
            st.add("KF_candidates", n_cand)
        if n_cand == 0:
            return self._reloc_failed(frame, stage=0)
        t0 = time.perf_counter()
        pose7, n_pnp, pid = RELOC.relocalize_candidates(
            self.gen, self.cam, self.track_cfg, self.map, frame, cand,
            cand_ok)
        n_pnp = int(n_pnp)                # the attempt's one read of PnP
        if st:
            st.add("Inliers_PnP_R", n_pnp)
            st.add("Time_PnP_R", round(time.perf_counter() - t0, 6))
        if n_pnp < RELOC.MIN_BOW_MATCHES:
            return self._reloc_failed(frame, stage=0)
        # full-map projection from the PnP pose with TH_RELOC; >= 12 matches
        # (the E-overload, PnPsolver.cc:364-396)
        cand_frame, n_bound = RELOC.fullmap_search(
            self.cam, self.track_cfg, self.map,
            frame._replace(pose7=pose7, point_ids=pid), 15.0,
            matching.TH_RELOC)
        if int(n_bound) < RELOC.MIN_PNP_FULLMAP:
            return self._reloc_failed(frame, stage=0)
        # S1 on the PnP + projection matches, then S2/S3 widen by full-map
        # projection against the WORKING map, deformed by any stage the
        # non-rigid branch won (reference SearchByProjection(.., 10, 100)
        # and (.., 3, 64), Tracking.cc:1997-2107)
        work_map, best_frame, n_good, used_nr = self._dual_optimize(
            self.map, cand_frame, stage=1, th=10)
        stage = 1
        for stg, radius, ham, th in ((2, 10.0, 100, 10), (3, 3.0, 64, 50)):
            if n_good >= RELOC.RELOC_GOOD:
                break
            stage = stg
            f2, _ = RELOC.fullmap_search(self.cam, self.track_cfg, work_map,
                                         best_frame, radius, ham)
            work_map, f3, n3, nr3 = self._dual_optimize(work_map, f2,
                                                        stage=stg, th=th)
            if n3 >= n_good:
                best_frame, n_good, used_nr = f3, n3, nr3 or used_nr
        if n_good < RELOC.RELOC_GOOD:
            return self._reloc_failed(frame, stage)
        if self.cfg.deformable:
            # commit the working, possibly deformed, map (the reference
            # writes SetWorldPos back for all moved points,
            # Optimizer.cc:797-809). This holds in localization-only mode
            # too: only with deformable=False does that mode never change
            # the map.
            self.map = DEF.set_rigidity_flags(work_map, best_frame,
                                              not used_nr)
        self.stats["relocs"] += 1
        self.kpi.on_reloc_success(self.frame_id)
        self.last_reloc_frame_id = self.frame_id
        self.state = TrackState.OK
        self._flush_reloc_stats(accepted=1, stage=stage)
        return best_frame, True

    def _reloc_failed(self, frame: Frame, stage: int):
        self.kpi.on_reloc_fail()
        self._flush_reloc_stats(accepted=0, stage=stage)
        return frame, False

    def _flush_reloc_stats(self, accepted: int, stage: int):
        if self.reloc_stats:
            self.reloc_stats.add("Stage", stage)
            self.reloc_stats.add("Accepted", accepted)
            self.reloc_stats.new_line()

    # ------------------------------------------------- loop closing
    def _count_clip(self, bits: int):
        if bits:
            self.stats["capacity_clips"] += 1
            self.stats["clip_bits"] |= bits

    def _try_close_loop(self, kf_slot: int):
        """Reference LoopClosing::Run body, once per new keyframe:
        DetectLoop (group consistency) -> ComputeSim3 -> CorrectLoop
        (+ SearchAndFuse) -> OptimizeEssentialGraph -> global BA. The query
        of this keyframe is queued now and read when the next keyframe
        arrives, as the reference's loop closer runs one keyframe behind."""
        self._loop_harvest()
        self._loop_dispatch(kf_slot)

    def _loop_dispatch(self, kf_slot: int):
        if self.vocab is None or self.n_keyframes < 10:
            return
        # >= 10 keyframes inserted since the last closure (reference
        # LoopClosing.cc:110, mLastLoopKFid + 10)
        if self.stats["kf_inserted"] - self._last_loop_kf_count < 10 \
                and self._last_loop_kf_count > 0:
            return
        q = self._bow_vec(self.map.kf_desc[kf_slot],
                          self.map.kf_kp_valid[kf_slot])
        # covisibility exclusion and the min-score gate (reference
        # LoopClosing.cc:103-150); the result stays on the device
        cand, scores, groups = KFDB.detect_loop_candidates_full(
            self.bow_db, q, self.map, kf_slot)
        self._loop_pending = (self._reset_gen, kf_slot, cand, scores, groups)

    def _loop_harvest(self):
        """Read a pending loop-candidate query (ONE packed read) and, when
        the detector confirms a candidate, close the loop."""
        pending, self._loop_pending = self._loop_pending, None
        if pending is None:
            return
        gen, kf_slot, cand, scores, groups = pending
        if gen != self._reset_gen:
            return
        # the slot's validity rides the same read (the keyframe may have
        # been culled since). The reference checks kf_valid only, not that
        # the slot still holds the same keyframe (kf_seq); so does the port.
        n = cand.shape[0]
        packed = torch.cat([
            cand.double(), scores.double(), groups.reshape(-1).double(),
            self.map.kf_valid[kf_slot].double()[None]]).tolist()
        if not packed[-1]:
            return
        K = self.map.K
        cand_groups = [
            (int(packed[c]),
             {k for k in range(K) if packed[2 * n + c * K + k]})
            for c in range(n) if packed[n + c] > 0]
        confirmed = self.loop_detector.update(cand_groups)
        if not confirmed:
            return
        loop_kf = confirmed[0]
        fix_scale = self.sensor != Sensor.MONOCULAR
        R12, t12, s12, n_in = LC.compute_sim3(
            self.gen, self.cam, self.map, kf_slot, loop_kf,
            self.cfg.scale_factor, fix_scale)
        if int(n_in) < LC.MIN_SIM3_INLIERS:
            return
        # the verification ladder BEFORE any irreversible correction
        # (reference LoopClosing.cc:306-400)
        R12, t12, s12, n_in2, n_total, clip_v = LC.verify_sim3(
            self.cam, self.map, kf_slot, loop_kf, R12, t12, s12,
            self.cfg.scale_factor, self.cfg.n_levels, fix_scale)
        n_in2, n_total, clip_v = torch.stack([
            n_in2.long(), n_total.long(), clip_v.long()]).tolist()
        self._count_clip(clip_v << 7)
        if n_in2 < LC.MIN_SIM3_INLIERS or n_total < 40:
            self.stats["loops_rejected"] = self.stats.get(
                "loops_rejected", 0) + 1
            return
        self.map, _, clip_e = LC.correct_and_optimize_graph(
            self.map, kf_slot, loop_kf, R12, t12, s12)
        # fuse the loop-side landmarks into the corrected neighborhood
        # (reference LoopClosing.cc:587-613)
        self.map, n_fused, clip_f = LC.search_and_fuse(
            self.cam, self.map, kf_slot, loop_kf, self.cfg.scale_factor,
            self.cfg.n_levels)
        n_fused, clip_e, clip_f = torch.stack([
            n_fused.long(), clip_e.long(), clip_f.long()]).tolist()
        self._count_clip((clip_e << 6) | (clip_f << 8))
        # global BA in bounded chunks between frames; a newer closure
        # supersedes a pending one (reference mnFullBAIdx)
        self._start_chunked_gba()
        self.loop_detector.reset()
        self.last_loop_kf = kf_slot
        self._last_loop_kf_count = self.stats["kf_inserted"]
        self.stats["loops_closed"] += 1
        self.stats["loop_points_fused"] = self.stats.get(
            "loop_points_fused", 0) + n_fused

    # ------------------------------------------------- chunked global BA
    def _start_chunked_gba(self):
        prob, clipped = LC.gba_problem(self.cam, self.map,
                                       self.cfg.scale_factor)
        self._count_clip(int(clipped) << 5)
        self._gba = {
            "prob": prob,
            "carry": ba_ops.ba_pcg_carry_init(prob),
            "sums": ba_ops.obs_sums(prob),
            "done": 0,
            # the snapshot's identity, for the merge
            "kf_seq": self.map.kf_seq.clone(),
            "lm_first_seq": self.map.lm_first_seq.clone(),
            "lm_valid": self.map.lm_valid.clone(),
        }

    def _advance_gba(self):
        """Queue ONE bounded chunk of the pending global BA; after the
        last one, merge the optimized snapshot into the live map, with the
        keyframes and landmarks created meanwhile carried along."""
        g = self._gba
        if g is None:
            return
        g["carry"] = ba_ops.ba_pcg_chunk(
            self.cam, g["prob"], g["carry"],
            n_outer=self.GBA_ITERS_PER_CHUNK, cg_iters=self.GBA_CG_ITERS,
            sums=g["sums"])
        g["done"] += 1
        if g["done"] < self.GBA_CHUNKS:
            return
        pose7, pts, _ = g["carry"]
        self.map = LC.gba_merge(self.map, pose7, pts, g["kf_seq"],
                                g["lm_first_seq"], g["lm_valid"])
        if self._loop_state is not None:
            self._loop_state = self._loop_state._replace(map=self.map)
        self._gba = None
        self.stats["gba_completed"] = self.stats.get("gba_completed", 0) + 1

    def shutdown(self):
        """Reference System::Shutdown: the pipelined loop's pending flags
        are read, the last keyframe's loop query is read and a pending
        chunked global BA is run to its end (the reference joins its GBA
        thread, System.cc:319-334)."""
        self._drain_pending()
        self._loop_harvest()
        while self._gba is not None:
            self._advance_gba()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
        """-> (timestamps, R_wc (N,3,3), t_wc (N,3)) numpy, tracked frames.
        The pipelined loop's pending verdicts are settled first."""
        self._drain_pending()
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

    def save_trajectory_kitti(self, path):
        """Reference System::SaveTrajectoryKITTI."""
        from ..utils import trajectory as traj
        _, R, t = self.get_trajectory()
        traj.save_kitti(path, R, t)

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

    def save_map(self, path):
        """Reference System::SaveMap (E-addition): one npz file with the
        whole map and the counters of the run; the vocabulary rides along, so
        that a loaded map relocalizes with the same word assignments."""
        extra = {
            "last_kf_slot": self.last_kf_slot,
            "n_keyframes": self.n_keyframes,
            "frame_id": self.frame_id,
        }
        if self.vocab is not None:
            extra.update(bow.vocabulary_to_arrays(self.vocab))
        map_io.save_map(path, self.map, extra=extra)

    def load_map(self, path):
        """Reference Tracking::LoadMap/BuildLoadedMap: restore a map file
        onto the system's device, refill the recognition database, and
        relocalize against the map from the next frame on."""
        self.map, extra = map_io.load_map(path, device=self.device)
        self.last_kf_slot = int(extra.get("last_kf_slot", 0))
        self.n_keyframes = int(extra.get("n_keyframes",
                                         int(self.map.n_keyframes())))
        # frame numbering resumes (reference Tracking::LoadMap), so the
        # KPI bookkeeping and the StatsReloc frame ids go on
        self.frame_id = int(extra.get("frame_id", self.frame_id))
        self.state = TrackState.LOST
        voc = bow.vocabulary_from_arrays(extra, device=self.device)
        if voc is not None:
            self._set_vocab(voc)
        if self.vocab is not None:
            for slot in torch.nonzero(self.map.kf_valid)[:, 0].tolist():
                self._db_add(slot)
        else:
            self._ensure_vocab()          # no vocabulary in the file: train
