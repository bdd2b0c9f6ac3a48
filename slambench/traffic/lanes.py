"""Traffic kind `lanes`: `lanes` camera streams localized in lock step
against per-lane copies of one map by `BatchedTracker.step`, closed loop
(the next step's frames are handed in when the previous step returns).

Set-up renders one period of the mix's motion, builds the map with the
single-stream system over the first `map_frames` frames, and starts the
lanes at the mix's `lane_starts`, frames of that map, dealt to the lanes
in an order drawn from the seed: a lane is bootstrapped from the system's
pose of its frame and runs one warm-up step. The window
continues every lane along the sequence, wrapping at its end. Mapping, the
BA and loop closing are bypassed: the lanes insert nothing.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import harness
from ..reference import check
from ..scenes.sequences import Sequence
from .stream import build_system, kernel_bounds, record_kernels


def run(ctx) -> dict:
    from orb_slam2_e_tpu_torch.models.frame import frame_from_features
    from orb_slam2_e_tpu_torch.parallel.batched import BatchedTracker
    cfg_file, mix = ctx.cell.config, ctx.cell.mix
    dev = torch.device(ctx.device)
    marks = [("start", time.perf_counter())]
    seq = Sequence(cfg_file, mix, ctx.seed, dev)
    harness.reset_peak(dev)          # the program's peak, not the renderer's
    marks.append(("render", time.perf_counter()))
    slam, _ = build_system(cfg_file, dev, ctx.seed)
    marks.append(("system", time.perf_counter()))
    for f in range(mix["map_frames"]):
        k = seq.index(f)
        slam.track_rgbd(seq.images[k], seq.depths[k], seq.timestamp(f))
    slam.get_trajectory()
    marks.append(("map frames", time.perf_counter()))
    poses = {int(round(ts * seq.fps)): p7 for ts, p7 in slam.trajectory
             if p7 is not None}
    B = mix["lanes"]
    starts = [int(s) for s in seq.rng.permutation(mix["lane_starts"])]
    boot = [frame_from_features(slam.cam, slam.extractor(torch.as_tensor(
        seq.images[seq.index(s)], device=dev)))._replace(pose7=poses[s])
        for s in starts]
    cfg = slam.cfg
    bt = BatchedTracker(slam.cam, slam.track_cfg, [slam.map] * B,
                        n_features=cfg.n_features,
                        scale_factor=cfg.scale_factor, n_levels=cfg.n_levels,
                        device=dev)
    bt.bootstrap(boot)
    refs = torch.full((B,), max(slam.last_kf_slot, 0), dtype=torch.int32,
                      device=dev)
    del slam, boot
    gc.collect()

    hooks = harness.Hooks(dev)
    hooks.wrap(bt.extractor, "extract_batch", "extract")
    hooks.wrap(bt, "_lanes", "track")

    def images(step):
        return np.stack([seq.images[seq.index(s + 1 + step)]
                         for s in starts])

    steps = []

    def do_step(step):
        ok, n_in = bt.step(images(step), refs)
        if hooks.capturing:
            lf = bt.last_frames
            steps.append((step, ok, n_in, lf, bt.state.lm_xyz,
                          bt.state.lm_valid))

    step = 0
    do_step(step)                     # the warm-up step
    step += 1
    hooks.sync()
    marks.append(("lanes", time.perf_counter()))
    harness.log_setup(ctx.t_start, marks)

    hooks.mode = "sync" if ctx.trace else "off"
    hooks.capturing = True
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    handins = []
    while True:
        handins.append(time.perf_counter())
        do_step(step)
        step += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    hooks.sync()
    t_end = time.perf_counter()
    hooks.capturing = False
    hooks.mode = "off"
    step_ms = np.diff(np.array(handins + [t_end])) * 1e3

    trace = None
    if ctx.trace:
        trace = harness.Trace()
        trace.spans = {k: list(v) for k, v in hooks.spans.items()}
        blur = record_kernels(hooks)
        first = step
        hooks.recording = True
        ev, n_prof, wall, a, b = harness.profile_stretch(
            lambda i: do_step(first + i),
            lambda i: i < mix["profile_frames"][0], hooks)
        hooks.recording = False
        step += n_prof
        trace.events = ev
        trace.stretch = {"frames": n_prof * B, "wall_s": wall, "t0_us": a,
                         "t1_us": b}
        kernel_bounds(blur, trace)

    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    hooks.remove()
    oks = torch.stack([s[1] for s in steps]).cpu()        # (steps, B)
    failed = int((~oks).sum())
    del bt
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = judge(ctx, seq, starts, steps, oks, False)
    control = (judge(ctx, seq, starts, steps, oks, True) if ctx.control
               else None)
    e2e = {"frames_per_s": len(handins) * B / (t_end - t0),
           "frame_ms_p90": harness.percentile(step_ms, 90),
           "setup_s": setup_s}
    return {"end_to_end": e2e, "attempted": len(handins) * B,
            "failed": failed, "memory_peak_bytes": int(memory_peak),
            "numbers": numbers, "control_numbers": control, "trace": trace}


def judge(ctx, seq, starts, steps, oks, control: bool) -> dict:
    """The reference's numbers for every tracked lane-frame of the window,
    the extraction on a sample of them drawn from the seed."""
    ref = check.Reference(ctx.cell.config, ctx.device)
    B = len(starts)
    rng = np.random.RandomState((ctx.seed + 7919) % 2 ** 32)
    okl = [(i, b) for i in range(len(steps)) for b in range(B)
           if bool(oks[i, b])]
    pick = rng.choice(len(okl), min(len(okl), ctx.cell.file["sample"]),
                      replace=False) if okl else []
    kp_pairs = []
    for j in sorted(pick):
        i, b = okl[j]
        step, _, _, lf, _, _ = steps[i]
        image = seq.images[seq.index(starts[b] + 1 + step)]
        r = ref.extract(image)
        cand = (ref.extract(image, torch.bfloat16) if control else
                (lf.uv_raw[b], lf.octave[b], lf.desc[b], lf.valid[b]))
        kp_pairs.append((cand, r))
    tracked = []
    for i, b in okl:
        _, _, n_in, lf, lm_xyz, lm_valid = steps[i]
        pid = lf.point_ids[b].long()
        safe = pid.clamp(min=0)
        tracked.append({"pose7": lf.pose7[b], "X": lm_xyz[b][safe],
                        "uvr": lf.uvr[b], "octave": lf.octave[b],
                        "bound": (pid >= 0) & lf.valid[b] & lm_valid[b][safe],
                        "n_in": n_in[b]})
    numbers = {"kp_mismatch_pct": check.kp_mismatch_pct(kp_pairs)}
    numbers.update(check.pose_numbers(ref, tracked, control, lanes=True))
    return numbers
