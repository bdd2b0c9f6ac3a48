"""Traffic kind `stream`: one camera stream through `SlamSystem`, closed
loop (a frame is handed in when the previous call returns, as when a
recorded sequence is processed).

Set-up renders one period of the mix's motion, builds the system and runs
the mix's `setup_frames` (initialization and the first keyframes). The
window continues the sequence for the run's seconds and ends with the
pipelined loop drained and the device synchronized. In a traced run
set-up ends with one short profiler session, which pays the device
tracer's start; the window's first `CAPTURES` mapping passes each run
inside a profiler session of their own, at the same keyframes whatever the
port's speed, and the window runs on for as long as they took; and
`profile_frames` more frames are profiled after the window. Frames up to
the cell's `ate_frames` that the window did not reach run untimed after
it, so that the ATE does not depend on speed. Then the program's state is
freed and the reference checks what the window produced.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import harness
from ..reference import ba as ref_ba
from ..reference import check, geometry
from ..reference import stereo as ref_stereo
from ..reference.trace import Events
from ..scenes.sequences import Sequence


def build_system(config: dict, device, seed: int):
    """The program's system for a configuration, and its rectifier."""
    from orb_slam2_e_tpu_torch.models.system import (Sensor, SlamSystem,
                                                     SystemConfig)
    from orb_slam2_e_tpu_torch.ops.camera import Camera
    s, sy = config["settings"], config["system"]
    cam = Camera.create(
        fx=s["Camera.fx"], fy=s["Camera.fy"], cx=s["Camera.cx"],
        cy=s["Camera.cy"], k1=s["Camera.k1"], k2=s["Camera.k2"],
        p1=s["Camera.p1"], p2=s["Camera.p2"], k3=s.get("Camera.k3", 0.0),
        bf=s["Camera.bf"], width=s["Camera.width"],
        height=s["Camera.height"])
    factor = s.get("DepthMapFactor", 1.0)
    cfg = SystemConfig(
        max_keyframes=sy["max_keyframes"], max_points=sy["max_points"],
        n_features=s["ORBextractor.nFeatures"],
        scale_factor=s["ORBextractor.scaleFactor"],
        n_levels=s["ORBextractor.nLevels"],
        ini_th_fast=s["ORBextractor.iniThFAST"],
        min_th_fast=s["ORBextractor.minThFAST"], th_depth=s["ThDepth"],
        depth_map_factor=1.0 if abs(factor - 1.0) < 1e-5 else 1.0 / factor,
        max_frames_between_kf=int(s["Camera.fps"]),
        pipeline=sy["pipeline"], loop_closing=sy["loop_closing"])
    sensor = Sensor.RGBD if config["sensor"] == "rgbd" else Sensor.STEREO
    slam = SlamSystem(cam, cfg, sensor, device=device, seed=seed % 2 ** 31)
    rect = None
    if config["sensor"] == "stereo":
        from orb_slam2_e_tpu_torch.utils.rectify import StereoRectifier
        m = np.asarray
        rect = StereoRectifier(
            m(s["LEFT.K"]).reshape(3, 3), m(s["LEFT.D"]),
            m(s["LEFT.R"]).reshape(3, 3), m(s["LEFT.P"]).reshape(3, 4),
            m(s["RIGHT.K"]).reshape(3, 3), m(s["RIGHT.D"]),
            m(s["RIGHT.R"]).reshape(3, 3), m(s["RIGHT.P"]).reshape(3, 4),
            s["LEFT.width"], s["LEFT.height"], device=device)
    return slam, rect


def install_hooks(hooks, slam, on_track, on_insert, bas):
    """The spans of the program's layers, around its calls; into `bas`, each
    local BA's problem and start, and the map that its mapping pass left."""
    from orb_slam2_e_tpu_torch.models import local_mapping, tracking
    from orb_slam2_e_tpu_torch.ops import ba
    hooks.wrap(slam, "_make_frame_inputs", "extract")
    hooks.wrap(tracking, "track_frame_fused", "track", on_out=on_track)
    hooks.wrap(tracking, "insert_keyframe", "insert", on_out=on_insert)
    solved = {}

    def on_solve(out, args):
        solved["prob"] = args[1]

    def on_local_ba(out, args):
        bas.append({"prob": solved.pop("prob", None),
                    "before": (args[2].kf_pose7, args[2].lm_xyz)})

    def on_map(out, args):
        for b in bas:
            b.setdefault("after", (out[0].kf_pose7, out[0].lm_xyz))
    hooks.wrap(ba, "ba_solve", None, on_out=on_solve)
    hooks.wrap(local_mapping, "local_ba", None, on_out=on_local_ba)
    hooks.wrap(slam, "_super_insert", "map", on_out=on_map)
    hooks.wrap(slam, "_loop_dispatch", "loop",
               idle=lambda when: when == "after"
               and slam._loop_pending is None)
    hooks.wrap(slam, "_loop_harvest", "loop",
               idle=lambda when: when == "before"
               and slam._loop_pending is None)
    hooks.wrap(slam, "_advance_gba", "loop",
               idle=lambda when: when == "before" and slam._gba is None)


# mapping passes profiled at the window's start in a traced run (the first
# calls of `SlamSystem._super_insert` after the set-up frames)
CAPTURES = 3


def record_kernels(hooks):
    """The argument lists of the extraction kernel's entry point while
    `hooks.recording`."""
    from orb_slam2_e_tpu_torch.ops import kernels
    return hooks.record(kernels, "fast_nms_blur_batch")


def kernel_bounds(blur, trace):
    """Each recorded extraction launch's least time from its inputs
    (reference)."""
    from ..reference import roofline
    for lanes, th_high, th_low in blur:
        levels = [img for lane in lanes for img in lane]
        trace.fast_nms_blur_bounds_s.append(roofline.fast_nms_blur_bound_s(
            roofline.fast_nms_blur_counts(levels, th_high, th_low)))


def segment_sum_bounds(seg) -> list:
    """Each recorded segment sum's least time from its inputs (reference);
    a sum into no segment launches nothing."""
    from ..reference import roofline
    out = []
    for n, idx, vals, *_ in seg:
        if n == 0:
            continue
        cols = int(vals.numel() // max(int(vals.shape[0]), 1))
        out.append(roofline.segment_sum_bound_s(
            n, cols, roofline.live_rows(idx, n)))
    return out


def run(ctx) -> dict:
    cfg_file, mix, cell = ctx.cell.config, ctx.cell.mix, ctx.cell.file
    dev = torch.device(ctx.device)
    stereo = cfg_file["sensor"] == "stereo"
    marks = [("start", time.perf_counter())]
    seq = Sequence(cfg_file, mix, ctx.seed, dev)
    harness.reset_peak(dev)          # the program's peak, not the renderer's
    marks.append(("render", time.perf_counter()))
    slam, rect = build_system(cfg_file, dev, ctx.seed)
    marks.append(("system", time.perf_counter()))
    hooks = harness.Hooks(dev)
    captured = {}
    fed = {"f": -1}

    def on_track(out, args):
        state, frame, _, flags = out
        captured[fed["f"]] = (frame, state.lm_xyz, state.lm_valid, flags)

    inserts = []

    def on_insert(out, args):
        state, frame_out = out
        frame = args[3]
        inserts.append({"pose7": frame.pose7, "uvr": frame.uvr,
                        "depth": frame.depth,
                        "new": (frame_out.point_ids >= 0)
                        & (frame.point_ids < 0),
                        "xyz": state.lm_xyz[frame_out.point_ids.clamp(
                            min=0).long()]})

    bas = []
    install_hooks(hooks, slam, on_track, on_insert, bas)
    if ctx.trace:
        from orb_slam2_e_tpu_torch.ops import scatter
        # (the profiled stretch records segment sums too; only the
        # sessions' calls are read)
        seg = hooks.record(scatter, "segment_sum")
        captures = hooks.profile_first(slam, "_super_insert", CAPTURES, seg)
    rects = {}

    def feed(f):
        fed["f"] = f
        k = seq.index(f)
        ts = seq.timestamp(f)
        if stereo:
            left, right = rect(seq.images[k], seq.rights[k])
            if hooks.capturing:
                rects[f] = (left, right)
            slam.track_stereo(left, right, ts)
        else:
            slam.track_rgbd(seq.images[k], seq.depths[k], ts)

    f = 0
    for _ in range(mix["setup_frames"]):
        feed(f)
        f += 1
    slam.get_trajectory()
    hooks.sync()
    marks.append(("setup frames", time.perf_counter()))
    if ctx.trace:
        harness.warm_profiler(hooks)
        marks.append(("profiler", time.perf_counter()))
    harness.log_setup(ctx.t_start, marks)

    # ---- the window
    hooks.mode = "sync" if ctx.trace else "off"
    hooks.capturing = True
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    maps0 = hooks.calls["map"]
    handins = []
    while True:
        handins.append(time.perf_counter())
        feed(f)
        f += 1
        # a traced run's window leaves its profiled mapping passes out of
        # its seconds, so that it reaches as far as an untraced one
        if time.perf_counter() - t0 - hooks.paused >= ctx.seconds:
            break
    slam.get_trajectory()          # the pipelined loop drained
    hooks.sync()
    t_end = time.perf_counter()
    hooks.capturing = False
    hooks.mode = "off"
    window = list(range(f - len(handins), f))
    kf_per_100 = 100.0 * (hooks.calls["map"] - maps0) / len(handins)
    frame_ms = np.diff(np.array(handins + [t_end])) * 1e3

    trace = None
    if ctx.trace:
        trace = harness.Trace()
        trace.spans = {k: list(v) for k, v in hooks.spans.items()}
        trace.captures = [(Events.from_profiler(prof),
                           segment_sum_bounds(calls))
                          for prof, calls, _ in captures]
        capture_s = [dt for *_, dt in captures]
        del captures, seg
        blur = record_kernels(hooks)
        first, kf0 = f, hooks.calls["map"]
        lo, hi = mix["profile_frames"]
        hooks.recording = True

        def more(i):
            # at least `lo` frames, and on to `hi` until one inserted a
            # keyframe, so that the stretch holds a mapping pass
            return i < lo or (i < hi and hooks.calls["map"] == kf0)
        ev, n_prof, wall, a, b = harness.profile_stretch(
            lambda i: feed(first + i), more, hooks)
        hooks.recording = False
        f += n_prof
        trace.events = ev
        trace.stretch = {"frames": n_prof, "wall_s": wall, "t0_us": a,
                         "t1_us": b}
        kernel_bounds(blur, trace)

    while f < cell["ate_frames"]:
        feed(f)
        f += 1
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    slam.shutdown()
    ts, _, twc = slam.get_trajectory()
    tracked_f = {int(round(t * seq.fps)) for t in ts}
    ate_idx = [i for i, t in enumerate(ts)
               if int(round(t * seq.fps)) < cell["ate_frames"]]
    ate_mm = None
    if len(ate_idx) >= 3:
        est = twc[ate_idx]
        gt = np.stack([seq.centres[seq.index(int(round(ts[i] * seq.fps)))]
                       for i in ate_idx])
        ate_mm = geometry.ate_rmse(est, gt) * 1e3
    failed = sum(1 for w in window if w not in tracked_f)

    # ---- the program's state freed; the reference judges the window
    hooks.remove()
    frames = {w: captured[w] for w in window if w in captured}
    rects = {w: rects[w] for w in window if w in rects}
    del slam, captured
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    windows = ba_windows(bas, ctx.device)
    del bas
    numbers = judge(ctx, seq, frames, rects, inserts, windows, window,
                    tracked_f, False)
    control = (judge(ctx, seq, frames, rects, inserts, windows, window,
                     tracked_f, True) if ctx.control else None)

    info = {"ate_mm": ate_mm, "keyframes_per_100": kf_per_100}
    if ctx.trace:
        info["capture_s"] = capture_s
    e2e = {"frames_per_s": len(handins) / (t_end - t0),
           "frame_ms_p90": harness.percentile(frame_ms, 90),
           "setup_s": setup_s}
    return {"end_to_end": e2e,
            "info": info,
            "attempted": len(handins), "failed": failed,
            "memory_peak_bytes": int(memory_peak), "numbers": numbers,
            "control_numbers": control, "trace": trace}


def ba_windows(bas, device):
    """The reference's view of each local BA the window ran (None where one
    ran without solving its problem): the problem's start and the program's
    result, read from the map that the mapping pass left, row by row where
    the problem took each keyframe and landmark from."""
    windows = []
    for b in bas:
        prob = b["prob"]
        if prob is None or "after" not in b:
            return None
        (kf0, lm0), (kf1, lm1) = b["before"], b["after"]
        start = (*geometry.unpack(prob.cam_pose7), prob.points)
        ci = torch.as_tensor(ref_ba.match_rows(kf0, prob.cam_pose7))
        pi = torch.as_tensor(ref_ba.match_rows(lm0, prob.points))
        dev = prob.cam_pose7.device
        pose = torch.where((ci >= 0)[:, None].to(dev),
                           kf1[ci.clamp(min=0).to(dev)], prob.cam_pose7)
        pts = torch.where((pi >= 0)[:, None].to(dev),
                          lm1[pi.clamp(min=0).to(dev)], prob.points)
        windows.append(ref_ba.Window(prob._asdict(), start,
                                     (*geometry.unpack(pose), pts), device))
    return windows


def judge(ctx, seq, frames, rects, inserts, windows, window, tracked_f,
          control: bool) -> dict:
    """The reference's numbers for the window's frames (see
    `reference.check`); with `control`, the control's."""
    cfg_file = ctx.cell.config
    ref = check.Reference(cfg_file, ctx.device)
    stereo = cfg_file["sensor"] == "stereo"
    rng = np.random.RandomState((ctx.seed + 7919) % 2 ** 32)
    ok_frames = [w for w in window if w in frames and w in tracked_f]
    sample = sorted(rng.choice(ok_frames, min(len(ok_frames),
                                               ctx.cell.file["sample"]),
                               replace=False)) if ok_frames else []
    kp_pairs, depth_pairs, rect_gap = [], [], 0.0
    for w in sample:
        fr = frames[w][0]
        k = seq.index(w)
        if stereo:
            rl, rr = ref.rectify(seq.images[k], seq.rights[k])
            if control:
                cl, cr = ref.rectify(seq.images[k], seq.rights[k],
                                     torch.bfloat16)
            else:
                cl, cr = rects[w]
            rect_gap = max(rect_gap, float(torch.maximum(
                (cl.float() - rl).abs().max(), (cr.float() - rr).abs().max())))
            image = rl
        else:
            image = seq.images[k]
        r_uv, r_oct, r_desc, r_valid = ref.extract(image)
        if control:
            cand = ref.extract(image, torch.bfloat16)
        else:
            cand = (fr.uv_raw, fr.octave, fr.desc, fr.valid)
        kp_pairs.append((cand, (r_uv, r_oct, r_desc, r_valid)))
        left = (fr.uv_raw.to(ref.device), fr.octave.to(ref.device),
                fr.desc.to(ref.device), fr.valid.to(ref.device))
        if stereo:
            d_ref = ref.stereo_depth(left, rl, rr)
            d_cand = (ref.stereo_depth(left, rl, rr, torch.bfloat16)
                      if control else fr.depth)
        else:
            dm = torch.as_tensor(seq.depths[k], device=ref.device)
            d_ref = ref_stereo.sample_depth(dm, left[0], ref.depth_factor)
            d_cand = (ref_stereo.sample_depth(dm, left[0], ref.depth_factor,
                                                dtype=torch.bfloat16)
                      if control else fr.depth)
        depth_pairs.append((d_cand.to(ref.device), d_ref, left[3]))
    tracked = []
    for w in ok_frames:
        fr, lm_xyz, lm_valid, flags = frames[w]
        pid = fr.point_ids.long()
        safe = pid.clamp(min=0)
        bound = (pid >= 0) & fr.valid & lm_valid[safe]
        tracked.append({"pose7": fr.pose7, "X": lm_xyz[safe], "uvr": fr.uvr,
                        "octave": fr.octave, "bound": bound,
                        "n_in": flags[1]})
    numbers = {"kp_mismatch_pct": check.kp_mismatch_pct(kp_pairs),
               "depth_mismatch_pct": check.depth_mismatch_pct(depth_pairs),
               "insert_gap_mm": check.insertion_gap_mm(ref, inserts,
                                                       control),
               "ba_shortfall": (ref_ba.shortfall(ref.cam, windows, control)
                                if windows is not None else None)}
    numbers.update(check.pose_numbers(ref, tracked, control))
    if stereo:
        numbers["rect_gap"] = rect_gap
    return numbers
