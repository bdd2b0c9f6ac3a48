"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernel (and, beside it, the earlier one-level
kernel as a timing baseline) from the sources in this checkout. Holds the kernel
against its plain torch twin on the card: the whole 8-level pyramid of a
640x480 frame in one launch, and two odd shapes through the one-level
entry. Times it by replaying a CUDA graph of back-to-back launches, at level
0 and for the pyramid, beside the baseline, the wrapper's call rate, the
plain version and the card's bound for the same work. Then drives
`SlamSystem` on the card through seven phases on synthetic 640x480 scenes
(8 levels, 1000 features), each through the entry point a user calls, with
`SystemConfig(pipeline=False)` and everything else, loop closing included,
at its default unless said:

1. RGB-D, 30 frames of the benchmark's orbit (camera fx=fy=500);
2. monocular, the benchmark's configuration (bench.py), 20 frames;
3. stereo, 12 frames;
4. RGB-D with frame 20 blanked, 25 frames: one LOST frame, relocalized;
5. loop closing: RGB-D, 96 frames on 1.1 turns of a circle looking outward
   at a ring of points (the scene of tests/test_loop_e2e.py at this image
   size). The revisit is detected, the Sim3 passes the ladder, the map is
   corrected and fused, the essential graph optimized, and the global BA
   runs in five chunks behind the frames that follow;
6. localization-only mode: on phase 1's map, 10 more frames of the orbit;
   then a map of the first 12 frames of the circle, and 30 more frames
   that turn away from everything mapped, so that temporary visual-odometry
   points carry the track. The maps must come out as they went in;
7. the deformable mode. Part A, the dual optimization at the default
   capacities: a two-keyframe map of a grid surface at rest, a frame that
   sees the surface deformed, one `_relocalize` with prisms (30 x 30
   landmarks) and one with hexahedra (18 x 18); the rigid branch must stay
   under the acceptance bar on every stage and the FEM-regularized one
   must reach it and deform the map. Part B, the workflow: map a smooth
   surface at rest (RGB-D, 20 frames), `save_map`, a new system in
   deformable mode, `load_map`, localization-only mode, and 20 frames of
   the surface deforming more and more, relocalized again after every
   true positive (`reloc_test_all_frames`).

Each phase checks tracking, trajectory error, its own gates and that every
extraction went through the kernel in exactly one launch (the launch count
is zeroed before the phase and read after it). Prints per-stage median ms,
the card's name and power limit, a JSON line describing the kernel, and as
its last line {"ok": true, "device": {...}}. Exits non-zero, without that
line, when there is no CUDA device or any phase fails. Imports no JAX.

    python3 chip_smoke.py --kernel-only

stops after the kernel's checks and timings.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

WIDTH, HEIGHT = 640, 480
FX = 500.0
BF = 40.0
TH_HIGH, TH_LOW = 20.0, 7.0
BLUR_TOL = 0.0           # kernel vs plain blur: the kernel pins the plain
                         # version's term order and rounding (scores: exact)
ODD_SHAPES = [(5, 37), (67, 130)]    # through the one-level entry
ATE_MAX = 0.08           # metres, SE3-aligned (the reference's e2e gate)
MONO_ATE_MAX = 0.10      # Sim3-aligned (the reference's mono e2e gate)
MONO_INIT_BY = 12        # mono must initialize by this frame
BLANK = 20               # the relocalization phase's blanked frame
# the loop phase: the ring scene and circle of tests/test_loop_e2e.py (480
# px wide, fx 260), at this image size with the same field of view
LOOP_FX = 260.0 * WIDTH / 480
LOOP_FRAMES = 96
LOOP_ATE_MAX = 0.10      # metres, SE3-aligned (the reference's loop gate)
LOC_ORBIT_FRAMES = 10    # localization-only frames on the RGB-D phase's map
LOC_MAPPED, LOC_FRAMES = 12, 30   # of the circle: mapped, then localized
# the localized frames end on temporary points alone (dead reckoning), so
# their error grows with every frame off the map
LOC_VO_ATE_MAX = 0.20
# the deformable phase. Part A: the field of `synthetic.deformed_grid_map`
# that separates the branches at these grids (the in-plane waves are short,
# so that no rigid pose fits more than a patch, and stay inside the
# projection search's radius, so that the matches are many); with
# `max_dist` 6 the 8-level pyramid's projection searches take the level-0
# features of the landmarks from 5 m on
DEFORM_FIELD = dict(seed=3, tang_wave=(6.3, 5.7), max_dist=6.0)
DEFORM_GRIDS = {1: dict(n_grid=30, defmag=0.3, tang=0.43),
                2: dict(n_grid=18, defmag=0.2, tang=0.4)}
RELOC_GOOD = 50          # the ladder's acceptance bar
# Part B: frames mapped at rest, then localized while the surface deforms
# up to this amplitude (metres along z; 0.3 of it in the plane)
DEFORM_MAPPED, DEFORM_FRAMES, DEFORM_AMPLITUDE = 20, 20, 0.25
# the reference on the CPU at this configuration relocalizes REF_RELOCS
# times with REF_TP true positives; the port may fall short by this much
DEFORM_REF_RELOCS, DEFORM_REF_TP, DEFORM_SLACK = 7, 6, 1
KERNEL_SOURCE = "orb_slam2_e_tpu_torch/csrc/fast_nms_blur.cu"
BASELINE_SOURCE = "orb_slam2_e_tpu_torch/csrc/fast_nms_blur_v1.cu"
REPLACES = "orb_slam2_e_tpu/ops/pallas_kernels.py:148"

# The card's bound for the kernel's work. Bytes: each pixel read once (f32)
# and written twice. Operations per pixel, none of them a fused multiply-add
# (the blur's rounding is pinned). The function as the reference computes it:
BYTES_PER_PIXEL = 12
OPS_FULL = {"ring differences": 16, "window trees (min and max)": 128,
            "arc reductions": 30, "combine and threshold": 7,
            "nms compares, ands, select": 16, "blur multiplies and adds": 26}
# With the kernel's exact early reject, what this run's data needs: on every
# pixel the 4 compass differences, 15 min/max and 1 compare of the reject and
# the blur; where the reject passes, the other 12 differences, the trees,
# reductions and thresholds; where the score is not 0, the NMS.
OPS_EVERY_PIXEL = 4 + 15 + 1 + 26
OPS_WHERE_SCORE_POSSIBLE = 12 + 128 + 30 + 7
OPS_WHERE_SCORE_NOT_0 = 16
# NVIDIA's data sheet, H100 SXM: 3.35 TB/s; 67 TFLOP/s float32 outside the
# tensor cores, which counts a fused multiply-add as two, so a stream of
# single operations peaks at half of it
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12 / 2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n: int = 50, rounds: int = 5) -> float:
    """Median over rounds of the mean device ms per call (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    per_round = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        stop.synchronize()
        per_round.append(start.elapsed_time(stop) / n)
    return statistics.median(per_round)


def make_scene():
    """bench.py's scene: the orbit's poses, ground-truth centres, and a
    renderer of grey, depth and right-camera images."""
    from orb_slam2_e_tpu_torch.utils.synthetic import (SyntheticScene,
                                                       orbit_trajectory)
    scene = SyntheticScene(n_points=600, seed=1, width=WIDTH, height=HEIGHT,
                           fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2)
    poses, centers = orbit_trajectory(n_frames=60, radius=1.2, forward=0.03)
    return scene, poses, centers


def grey(scene, R, t):
    return scene.render(R, t).astype(np.uint8)


def ring_camera() -> dict:
    return dict(fx=LOOP_FX, fy=LOOP_FX, cx=WIDTH / 2, cy=HEIGHT / 2, bf=BF,
                width=WIDTH, height=HEIGHT)


def make_ring():
    """The loop phase's scene: a band of points around the origin, and 1.1
    turns of a circle inside it, looking outward."""
    from orb_slam2_e_tpu_torch.utils.synthetic import (make_ring_scene,
                                                       circle_trajectory)
    cam = ring_camera()
    scene = make_ring_scene(n_points=1000, seed=2, ring_radius=9.0,
                            **{k: cam[k] for k in ("fx", "fy", "cx", "cy",
                                                   "width", "height")})
    poses, centers = circle_trajectory(n_frames=LOOP_FRAMES, radius=2.0,
                                       frac=1.1)
    return scene, poses, centers


def replay_ms(enqueue, n: int = 40, replays: int = 15,
              warm_up_s: float = 0.25) -> float:
    """Device ms per call of `enqueue(i)`, i in range(n), captured back to
    back into one CUDA graph: median over replays of the graph's time (CUDA
    events) over n. No host work lies between the launches. The graph is
    first replayed for `warm_up_s` seconds, so that the card's clocks are up
    when the timed replays run."""
    enqueue(0)                       # outside the capture: loads the module
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            enqueue(i)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warm_up_s:
        for _ in range(20):
            graph.replay()
        torch.cuda.synchronize()
    per_replay = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        per_replay.append(start.elapsed_time(stop) / n)
    return statistics.median(per_replay)


def bound_ms(levels, scores):
    """The least ms the card could take for these images: (bound, what
    binds, bound of the function computed in full, counts). The operations
    are those this run's data needs after the exact early reject."""
    from orb_slam2_e_tpu_torch.ops import kernels
    n_px = sum(img.numel() for img in levels)
    n_possible = sum(int(kernels.may_score(img, min(TH_HIGH, TH_LOW)).sum())
                     for img in levels)
    n_not_0 = sum(int((sc != 0).sum()) for sc in scores)
    ops = (n_px * OPS_EVERY_PIXEL + n_possible * OPS_WHERE_SCORE_POSSIBLE
           + n_not_0 * OPS_WHERE_SCORE_NOT_0)
    by_bytes = n_px * BYTES_PER_PIXEL / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    full = max(by_bytes,
               n_px * sum(OPS_FULL.values()) / PEAK_F32_OPS_PER_S * 1e3)
    return (max(by_bytes, by_ops), "operations" if by_ops > by_bytes
            else "bytes", full,
            {"pixels": n_px, "score_possible": n_possible,
             "score_not_0": n_not_0, "operations": ops})


def load_baseline(so_path: str):
    """The earlier one-level kernel: launch(img, score, blur)."""
    from orb_slam2_e_tpu_torch.ops import kernels
    lib = ctypes.CDLL(so_path)
    lib.fast_nms_blur_v1_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.fast_nms_blur_v1_launch.restype = ctypes.c_int
    taps = kernels.gaussian_taps7()

    def launch(img, score, blur):
        err = lib.fast_nms_blur_v1_launch(
            img.data_ptr(), score.data_ptr(), blur.data_ptr(), img.shape[0],
            img.shape[1], TH_HIGH, TH_LOW, taps.ctypes.data,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"baseline launch failed: CUDA error {err}")
    return launch


def expect_equal(got, want, what):
    (sk, bk), (sp, bp) = got, want
    score_eq = torch.equal(sk, sp)
    blur_err = (bk - bp).abs().max().item()
    print(f"{what} {tuple(sk.shape)}: score exact={score_eq} "
          f"({int((sk > 0).sum())} corners) blur max|diff|={blur_err:.3g}")
    if not score_eq or not blur_err <= BLUR_TOL:
        raise AssertionError(f"kernel disagrees with plain: {what}")
    return blur_err


def time_kernels(levels, baseline):
    """Replay times (ms) of the kernel and of the baseline at level 0 and
    for the pyramid, each on preallocated outputs. `warm`: every launch on
    the same buffers, which stay in the 50 MB L2, as the extractor finds a
    level the resize has just written. `cold`: every launch of the graph on
    buffers of its own (>= 147 MB in all), so none is in L2."""
    from orb_slam2_e_tpu_torch.ops import kernels
    n = 40

    def buffer_sets(imgs, count):
        _, total = kernels.pyramid_layout([tuple(i.shape) for i in imgs])
        return [([i.clone() for i in imgs],
                 torch.empty((2, total), dtype=torch.float32, device="cuda"))
                for _ in range(count)]

    def ours(sets):
        def enqueue(i):
            imgs, out = sets[i % len(sets)]
            kernels.launch_into(imgs, out[0], out[1], TH_HIGH, TH_LOW)
        return enqueue

    def theirs(sets):
        def enqueue(i):
            imgs, out = sets[i % len(sets)]
            shapes = [tuple(img.shape) for img in imgs]
            for img, sc, bl in zip(imgs,
                                   kernels.pyramid_views(out[0], shapes),
                                   kernels.pyramid_views(out[1], shapes)):
                baseline(img, sc, bl)
        return enqueue

    times = {}
    for what, imgs in (("level0", levels[:1]), ("pyramid", levels)):
        for cache, count in (("warm", 1), ("cold", n)):
            sets = buffer_sets(imgs, count)
            # baseline, kernel, kernel, baseline: drift shows as a gap
            # between the two readings of one kernel
            order = (("baseline", theirs), ("kernel", ours),
                     ("kernel", ours), ("baseline", theirs))
            for who, make in order:
                times.setdefault(f"{who}_{what}_{cache}", []).append(
                    replay_ms(make(sets), n))
            del sets
    for key, pair in times.items():
        print(f"replay {key}: {pair[0]:.5f} / {pair[1]:.5f} ms")
    return {key: min(pair) for key, pair in times.items()}


def check_kernel(image0: np.ndarray):
    """Kernel vs plain twin on the card: the frame's whole pyramid in one
    launch, odd shapes through the one-level entry, the baseline kernel
    level by level; then the timings. Returns the kernel's JSON record."""
    from orb_slam2_e_tpu_torch.ops import kernels, orb
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    (_, log), (baseline_so, baseline_log) = kernels.compile_sources(
        [os.path.join(here, KERNEL_SOURCE),
         os.path.join(here, BASELINE_SOURCE)])
    kernels.build()
    print(f"kernel build (both sources at once): "
          f"{time.perf_counter() - t0:.2f} s "
          f"(nvcc {' '.join(kernels.NVCC_FLAGS)})")
    print(log.strip())
    print(baseline_log.strip())
    baseline = load_baseline(baseline_so)

    ex = orb.OrbExtractor()
    img0 = torch.as_tensor(image0, device="cuda").to(torch.float32)
    levels = [img0] + [
        orb.resize_bilinear(img0, int(round(HEIGHT / s)),
                            int(round(WIDTH / s))).contiguous()
        for s in ex.scales[1:]]
    before = kernels.fast_nms_blur.launches
    got = kernels.fast_nms_blur_pyramid(levels, TH_HIGH, TH_LOW)
    if kernels.fast_nms_blur.launches != before + 1:
        raise AssertionError("the pyramid took more than one launch")
    want = kernels.fast_nms_blur_pyramid_plain(levels, TH_HIGH, TH_LOW)
    torch.cuda.synchronize()
    max_err = 0.0
    for lvl, (g, w) in enumerate(zip(got, want)):
        max_err = max(max_err, expect_equal(g, w, f"pyramid level {lvl}"))
        sb, bb = torch.empty_like(levels[lvl]), torch.empty_like(levels[lvl])
        baseline(levels[lvl], sb, bb)
        expect_equal((sb, bb), w, f"baseline level {lvl}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in ODD_SHAPES:
        img = torch.randint(0, 256, shape, generator=gen,
                            device="cuda").to(torch.float32)
        max_err = max(max_err, expect_equal(
            kernels.fast_nms_blur(img, TH_HIGH, TH_LOW),
            kernels.fast_nms_blur_plain(img, TH_HIGH, TH_LOW), "one level"))

    replay = time_kernels(levels, baseline)
    call_ms = time_ms(lambda: kernels.fast_nms_blur(img0, TH_HIGH, TH_LOW))
    call_pyr_ms = time_ms(lambda: kernels.fast_nms_blur_pyramid(
        levels, TH_HIGH, TH_LOW))
    plain_ms = time_ms(lambda: kernels.fast_nms_blur_pyramid_plain(
        levels, TH_HIGH, TH_LOW), n=10)
    # the NMS has work only where the score map, before suppression, is
    # not 0
    raw = [kernels.fast_score_map(img, TH_HIGH, TH_LOW) for img in levels]
    b0, by0, full0, n0 = bound_ms(levels[:1], raw[:1])
    bp, byp, fullp, npyr = bound_ms(levels, raw)
    print(f"wrapper call rate (CUDA events around 50 calls of the Python "
          f"wrapper, not the kernel's time): level 0 {call_ms:.4f} ms, "
          f"pyramid {call_pyr_ms:.4f} ms; plain torch pyramid "
          f"{plain_ms:.4f} ms")
    print(f"bound, level 0: {b0:.5f} ms by {by0} ({json.dumps(n0)}); "
          f"computed in full {full0:.5f} ms")
    print(f"bound, pyramid: {bp:.5f} ms by {byp} ({json.dumps(npyr)}); "
          f"computed in full {fullp:.5f} ms")
    print(f"the kernel reaches {b0 / replay['kernel_level0_warm']:.1%} of "
          f"its bound at level 0 and {bp / replay['kernel_pyramid_warm']:.1%}"
          f" for the pyramid (replay, warm)")
    print("the earlier one-level kernel (baseline, replay, warm): "
          + json.dumps({"level0_ms": replay["baseline_level0_warm"],
                        "pyramid_8_launches_ms":
                            replay["baseline_pyramid_warm"]}))

    # the extractor on the card keeps the CPU path's level-0 keypoints
    feats_gpu = ex(img0)
    feats_cpu = ex(img0.cpu())
    lvl0 = feats_cpu.octave == 0
    for name in ("uv", "response", "valid"):
        a = getattr(feats_gpu, name).cpu()[lvl0]
        b = getattr(feats_cpu, name)[lvl0]
        if not torch.equal(a, b):
            raise AssertionError(f"level-0 {name} differs card vs CPU")
    print("extractor: level-0 keypoints on the card equal the CPU path")
    record = {"name": "fast_nms_blur", "route": "cuda",
              "source": KERNEL_SOURCE, "replaces": REPLACES, "launches": 0,
              "max_abs_err": max_err, "ms": replay["kernel_pyramid_warm"],
              "plain_ms": plain_ms, "bound_ms": bp, "bound_by": byp,
              "library_ms": None, "bound_counts": npyr,
              "bound_ms_computed_in_full": fullp,
              "level0_bound_ms": b0, "level0_bound_by": by0,
              "wrapper_call_ms_level0": call_ms,
              "wrapper_call_ms_pyramid": call_pyr_ms}
    record.update({f"replay_ms_{k}": v for k, v in replay.items()})
    return record


def instrument(slam):
    """Time the system's stages between synchronizations. Returns
    {stage: [ms]}. `insert+map` contains the loop closer's stages, which
    run behind every inserted keyframe: `loop query` (the candidate query
    queued for the new keyframe), `loop harvest` (the previous query read,
    no closure) and `closure` (a harvest that closed a loop: Sim3, ladder,
    correction, essential graph, fusion, the global BA's set-up). `gba
    chunk` is one chunk of the global BA, queued behind a frame's step."""
    stages = {"extract": "_make_frame_inputs", "track": "_track_step",
              "insert+map": "_insert_keyframe", "relocalize": "_relocalize",
              "init": "_initialize", "loop query": "_loop_dispatch",
              "loop harvest": "_loop_harvest", "gba chunk": "_advance_gba"}
    stage_ms = {k: [] for k in list(stages) + ["closure"]}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            # a stage that has nothing to do is not a sample of it
            idle = {"loop harvest": slam._loop_pending is None,
                    "gba chunk": slam._gba is None}.get(key, False)
            closed = slam.stats["loops_closed"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if key == "loop query" and slam._loop_pending is None:
                idle = True             # gated off: too few keyframes
            if not idle:
                closure = (key == "loop harvest"
                           and slam.stats["loops_closed"] > closed)
                stage_ms["closure" if closure else key].append(ms)
            return out
        return wrapper

    for key, attr in stages.items():
        setattr(slam, attr, timed(key, getattr(slam, attr)))
    return stage_ms


def drive(name, slam, inputs, centers, with_scale, first_frame=0,
          stage_ms=None):
    """One phase: `inputs[k]` fed to the sensor's entry point for every
    frame, timed per stage between synchronizations. A system that an
    earlier phase drove goes on from `first_frame` with the `stage_ms` it
    was instrumented with. Returns a summary."""
    from orb_slam2_e_tpu_torch.models.system import Sensor
    from orb_slam2_e_tpu_torch.ops import kernels
    from orb_slam2_e_tpu_torch.utils.trajectory import ate_rmse
    if stage_ms is None:
        stage_ms = instrument(slam)
    for v in stage_ms.values():
        v.clear()
    entry = {Sensor.RGBD: slam.track_rgbd, Sensor.MONOCULAR:
             slam.track_monocular, Sensor.STEREO: slam.track_stereo}[
        slam.sensor]

    kernels.fast_nms_blur.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est, frame_ms, vo_frames = [], {"chunk": [], "plain": []}, []
    events = {"loops_closed": [], "gba_completed": []}
    for k, args in enumerate(inputs):
        chunk = slam._gba is not None     # a global-BA chunk rides behind
        counts = {key: slam.stats.get(key, 0) for key in events}
        tf = time.perf_counter()
        pose = entry(*args, (first_frame + k) / 30.0)
        frame_ms["chunk" if chunk else "plain"].append(
            (time.perf_counter() - tf) * 1e3)
        if slam.vo_mode:
            vo_frames.append(k)
        for key, before in counts.items():
            if slam.stats.get(key, 0) > before:
                events[key].append(k)
        est.append(None if pose is None else
                   (-pose[0].T @ pose[1]).double().cpu().numpy())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.fast_nms_blur.launches

    tracked = [k for k, c in enumerate(est) if c is not None]
    _, Rwc, twc = slam.get_trajectory()
    if not (np.isfinite(Rwc).all() and np.isfinite(twc).all()
            and twc.shape[1:] == (3,) and len(twc) >= len(tracked)):
        raise AssertionError(f"{name}: trajectory not finite or misshaped")
    ate = ate_rmse(np.stack([est[k] for k in tracked]),
                   centers[tracked].astype(np.float64), with_scale)
    n_pts = int(slam.map.lm_valid.sum())
    print(f"[{name}] frames {len(inputs)}: tracked {len(tracked)}, "
          f"keyframes {slam.n_keyframes}, landmarks {n_pts}, "
          f"{'Sim3' if with_scale else 'SE3'} ATE {ate:.4f} m")
    print(f"[{name}] wall {wall:.2f} s = {len(inputs) / wall:.2f} frames/s; "
          f"stats {slam.stats}")
    for key, v in stage_ms.items():
        if v:
            print(f"[{name}] stage {key}: median {statistics.median(v):.2f} "
                  f"ms over {len(v)} calls")
    if frame_ms["chunk"]:
        print(f"[{name}] frame ms (stages synchronized): median "
              f"{statistics.median(frame_ms['chunk']):.2f} with a global-BA "
              f"chunk behind it ({len(frame_ms['chunk'])} frames), "
              f"{statistics.median(frame_ms['plain']):.2f} without "
              f"({len(frame_ms['plain'])} frames)")
    if events["loops_closed"]:
        print(f"[{name}] loop closed behind frame {events['loops_closed']}, "
              f"global BA merged behind frame {events['gba_completed']}")
    print(f"[{name}] fast_nms_blur launches: {launches}")
    return {"tracked": tracked, "ate": ate, "launches": launches,
            "vo_frames": vo_frames, "stage_ms": stage_ms}


def expect(cond, what):
    if not cond:
        raise AssertionError(what)


def run_rgbd(scene, poses, centers, n_frames=30):
    from orb_slam2_e_tpu_torch.models.system import (SlamSystem,
                                                     SystemConfig, Sensor)
    from orb_slam2_e_tpu_torch.ops.camera import Camera
    cam = Camera.create(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2, bf=BF)
    slam = SlamSystem(cam, SystemConfig(pipeline=False), Sensor.RGBD,
                      device="cuda")
    inputs = [(grey(scene, R, t), scene.depth_map(R, t))
              for R, t in poses[:n_frames]]
    r = drive("rgbd", slam, inputs, centers[:n_frames], with_scale=False)
    expect(len(r["tracked"]) >= n_frames - 1, f"rgbd tracked {r['tracked']}")
    expect(r["ate"] < ATE_MAX, f"rgbd ATE {r['ate']}")
    expect(r["launches"] == n_frames, f"rgbd launches {r['launches']}")
    expect(slam.stats["loops_closed"] == 0, f"rgbd stats {slam.stats}")
    return r["launches"], (slam, r["stage_ms"], n_frames)


def run_mono(scene, poses, centers, n_frames=20):
    """bench.py's monocular configuration."""
    from orb_slam2_e_tpu_torch.models.system import (SlamSystem,
                                                     SystemConfig, Sensor)
    from orb_slam2_e_tpu_torch.ops.camera import Camera
    cam = Camera.create(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2,
                        width=WIDTH, height=HEIGHT)
    cfg = SystemConfig(max_keyframes=64, max_points=16384, n_features=1000,
                       n_levels=8, max_frames_between_kf=6,
                       min_init_matches=80, pipeline=False)
    slam = SlamSystem(cam, cfg, Sensor.MONOCULAR, device="cuda", seed=0)
    inputs = [(grey(scene, R, t),) for R, t in poses[:n_frames]]
    r = drive("mono", slam, inputs, centers[:n_frames], with_scale=True)
    first = r["tracked"][0] if r["tracked"] else n_frames
    print(f"[mono] initialized at frame {first}")
    expect(first <= MONO_INIT_BY, f"mono initialized at {first}")
    expect(r["tracked"] == list(range(first, n_frames)),
           f"mono lost frames after init: {r['tracked']}")
    expect(r["ate"] < MONO_ATE_MAX, f"mono ATE {r['ate']}")
    expect(r["launches"] == n_frames, f"mono launches {r['launches']}")
    return r["launches"]


def run_stereo(scene, poses, centers, n_frames=12):
    from orb_slam2_e_tpu_torch.models.system import (SlamSystem,
                                                     SystemConfig, Sensor)
    from orb_slam2_e_tpu_torch.ops.camera import Camera
    cam = Camera.create(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2, bf=BF,
                        width=WIDTH, height=HEIGHT)
    slam = SlamSystem(cam, SystemConfig(pipeline=False), Sensor.STEREO,
                      device="cuda")
    # the right camera sits one baseline along the camera x axis
    shift = np.array([-BF / FX, 0.0, 0.0], np.float32)
    inputs = [(grey(scene, R, t), grey(scene, R, t + shift))
              for R, t in poses[:n_frames]]
    r = drive("stereo", slam, inputs, centers[:n_frames], with_scale=False)
    expect(len(r["tracked"]) >= n_frames - 1,
           f"stereo tracked {r['tracked']}")
    expect(r["ate"] < ATE_MAX, f"stereo ATE {r['ate']}")
    expect(r["launches"] == 2 * n_frames,
           f"stereo launches {r['launches']}")
    return r["launches"]


def run_reloc(scene, poses, centers, n_frames=25):
    """RGB-D with one blank frame: tracking is lost there and the next
    frame is relocalized (BoW candidates, PnP RANSAC, the rigid ladder)."""
    from orb_slam2_e_tpu_torch.models.system import (SlamSystem,
                                                     SystemConfig, Sensor)
    from orb_slam2_e_tpu_torch.ops.camera import Camera
    cam = Camera.create(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2, bf=BF)
    slam = SlamSystem(cam, SystemConfig(pipeline=False), Sensor.RGBD,
                      device="cuda")
    inputs = [(grey(scene, R, t), scene.depth_map(R, t))
              for R, t in poses[:n_frames]]
    inputs[BLANK] = (np.zeros_like(inputs[BLANK][0]), inputs[BLANK][1])
    r = drive("reloc", slam, inputs, centers[:n_frames], with_scale=False)
    lost = sorted(set(range(n_frames)) - set(r["tracked"]))
    print(f"[reloc] lost frames {lost}; relocs {slam.stats['relocs']}; "
          f"kpi tp/fp/fn {slam.kpi.tp}/{slam.kpi.fp}/{slam.kpi.fn}")
    expect(lost == [BLANK], f"reloc lost {lost}")
    expect(slam.stats["relocs"] == 1, f"relocs {slam.stats['relocs']}")
    expect(slam.kpi.tp == 1, f"kpi.tp {slam.kpi.tp}")
    expect(r["ate"] < ATE_MAX, f"reloc ATE {r['ate']}")
    expect(r["launches"] == n_frames, f"reloc launches {r['launches']}")
    return r["launches"]


def run_loop(seed=0):
    """Loop closing on the card, at full width: the default configuration
    around 1.1 turns of the ring. `seed` seeds the system's RANSAC draws."""
    from orb_slam2_e_tpu_torch.models.system import (SlamSystem,
                                                     SystemConfig, Sensor)
    from orb_slam2_e_tpu_torch.models import loop_closing
    from orb_slam2_e_tpu_torch.ops.camera import Camera
    scene, poses, centers = make_ring()
    slam = SlamSystem(Camera.create(**ring_camera()),
                      SystemConfig(pipeline=False), Sensor.RGBD,
                      device="cuda", seed=seed)
    inputs = [(grey(scene, R, t), scene.depth_map(R, t)) for R, t in poses]
    n = len(inputs)
    # the loop closer's own steps, timed where the system calls them
    parts = ("compute_sim3", "verify_sim3", "correct_and_optimize_graph",
             "search_and_fuse", "gba_problem", "gba_merge")
    part_ms = {k: [] for k in parts}
    saved = {k: getattr(loop_closing, k) for k in parts}

    def timed(key):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = saved[key](*args, **kwargs)
            torch.cuda.synchronize()
            part_ms[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    for key in parts:
        setattr(loop_closing, key, timed(key))
    try:
        r = drive("loop", slam, inputs, centers, with_scale=False)
    finally:
        for key in parts:
            setattr(loop_closing, key, saved[key])
    for key, v in part_ms.items():
        if v:
            print(f"[loop] {key}: median {statistics.median(v):.2f} ms over "
                  f"{len(v)} calls")
    t0 = time.perf_counter()
    pending = slam._gba is not None
    slam.shutdown()
    print(f"[loop] shutdown {(time.perf_counter() - t0) * 1e3:.1f} ms "
          f"(a global BA was {'still' if pending else 'not'} pending); "
          f"stats {slam.stats}")
    print(f"[loop] capacity_clips {slam.stats['capacity_clips']} clip_bits "
          f"{slam.stats['clip_bits']:#x}; loop edges "
          f"{int((slam.map.kf_loop_edge >= 0).sum())}")
    expect(slam.stats["loops_closed"] >= 1, f"no loop closed: {slam.stats}")
    expect(slam.stats.get("gba_completed", 0) >= 1,
           f"no global BA completed: {slam.stats}")
    expect(slam._gba is None and slam._loop_pending is None,
           "shutdown left work pending")
    expect(len(r["tracked"]) >= n - 6, f"loop tracked {len(r['tracked'])}")
    expect(r["ate"] < LOOP_ATE_MAX, f"loop ATE {r['ate']}")
    expect(len(r["stage_ms"]["loop query"]) >= 10
           and len(r["stage_ms"]["closure"]) >= 1
           and len(r["stage_ms"]["gba chunk"]) >= slam.GBA_CHUNKS,
           "the loop closer's stages did not all run")
    expect(r["launches"] == n, f"loop launches {r['launches']}")
    expect(bool(torch.isfinite(slam.map.kf_pose7).all())
           and bool(torch.isfinite(slam.map.lm_xyz).all()),
           "loop: the map is not finite")
    return r["launches"]


def _map_copy(slam):
    return {k: v.clone() for k, v in slam.map._asdict().items()}


def _expect_map_unchanged(slam, before, what):
    for k, v in slam.map._asdict().items():
        expect(torch.equal(v, before[k]), f"{what}: map field {k} changed")


def run_loc(orbit, rgbd_state):
    """Localization-only mode: on the RGB-D phase's map along the orbit,
    then off the edge of a freshly mapped arc of the ring."""
    from orb_slam2_e_tpu_torch.models.system import (SlamSystem,
                                                     SystemConfig, Sensor)
    from orb_slam2_e_tpu_torch.ops.camera import Camera
    scene, poses, centers = orbit
    slam, stage_ms, n0 = rgbd_state
    before, n_kf = _map_copy(slam), slam.n_keyframes
    slam.activate_localization_mode()
    sl = slice(n0, n0 + LOC_ORBIT_FRAMES)
    inputs = [(grey(scene, R, t), scene.depth_map(R, t))
              for R, t in poses[sl]]
    r = drive("loc-orbit", slam, inputs, centers[sl], with_scale=False,
              first_frame=n0, stage_ms=stage_ms)
    launches = r["launches"]
    expect(len(r["tracked"]) == LOC_ORBIT_FRAMES,
           f"loc-orbit tracked {r['tracked']}")
    expect(r["launches"] == LOC_ORBIT_FRAMES,
           f"loc-orbit launches {r['launches']}")
    _expect_map_unchanged(slam, before, "loc-orbit")
    expect(slam.n_keyframes == n_kf, "loc-orbit inserted a keyframe")
    print(f"[loc-orbit] map unchanged: {n_kf} keyframes, "
          f"{int(slam.map.lm_valid.sum())} landmarks; VO frames "
          f"{r['vo_frames']}")

    scene, poses, centers = make_ring()
    slam = SlamSystem(Camera.create(**ring_camera()),
                      SystemConfig(pipeline=False), Sensor.RGBD,
                      device="cuda")
    n1, n2 = LOC_MAPPED, LOC_MAPPED + LOC_FRAMES
    inputs = [(grey(scene, R, t), scene.depth_map(R, t))
              for R, t in poses[:n2]]
    r = drive("loc-map", slam, inputs[:n1], centers[:n1], with_scale=False)
    launches += r["launches"]
    expect(len(r["tracked"]) == n1, f"loc-map tracked {r['tracked']}")
    before, n_kf = _map_copy(slam), slam.n_keyframes
    slam.activate_localization_mode()
    r = drive("loc-vo", slam, inputs[n1:], centers[n1:n2], with_scale=False,
              first_frame=n1, stage_ms=r["stage_ms"])
    launches += r["launches"]
    print(f"[loc-vo] VO frames {r['vo_frames']}; map unchanged: {n_kf} "
          f"keyframes, {int(slam.map.lm_valid.sum())} landmarks")
    expect(len(r["tracked"]) == LOC_FRAMES, f"loc-vo tracked {r['tracked']}")
    expect(len(r["vo_frames"]) >= 1, "loc-vo: the VO flag never rose")
    expect(r["ate"] < LOC_VO_ATE_MAX, f"loc-vo ATE {r['ate']}")
    _expect_map_unchanged(slam, before, "loc-vo")
    expect(slam.n_keyframes == n_kf, "loc-vo inserted a keyframe")
    expect(launches == LOC_ORBIT_FRAMES + n2, f"loc launches {launches}")
    slam.deactivate_localization_mode()
    return launches


def _deformed_system(el_type, deformable, stats_path):
    """tests/test_reloc_kpi.py::build_deformed_system at the default
    capacities, on the card: a LOST monocular system that holds the
    two-keyframe grid map, a vocabulary trained on the landmarks'
    descriptors and the recognition database. Returns (system, the unbound
    query frame, the scene's arrays)."""
    from orb_slam2_e_tpu_torch.models.system import (SlamSystem,
                                                     SystemConfig, Sensor,
                                                     TrackState)
    from orb_slam2_e_tpu_torch.ops import bow
    from orb_slam2_e_tpu_torch.ops.camera import Camera
    from orb_slam2_e_tpu_torch.utils import convert
    from orb_slam2_e_tpu_torch.utils.synthetic import deformed_grid_map
    cfg = SystemConfig(pipeline=False, deformable=deformable,
                       el_type=el_type, stats_reloc_path=stats_path)
    slam = SlamSystem(Camera.create(fx=FX, fy=FX, cx=WIDTH / 2,
                                    cy=HEIGHT / 2, width=WIDTH,
                                    height=HEIGHT),
                      cfg, Sensor.MONOCULAR, device="cuda")
    a = deformed_grid_map(
        max_keyframes=cfg.max_keyframes, max_points=cfg.max_points,
        max_features=slam.extractor.capacity, fx=FX, cx=WIDTH / 2,
        cy=HEIGHT / 2, **DEFORM_GRIDS[el_type], **DEFORM_FIELD)
    slam.map = convert.map_state_from_numpy(a["map"], "cuda")
    slam._set_vocab(bow.train_vocabulary(a["desc"], k=8, L=2, iters=3,
                                         device="cuda"))
    slam.n_keyframes, slam.last_kf_slot = 2, 1
    slam.state = TrackState.LOST
    for slot in (0, 1):
        slam._db_add(slot)
    return slam, convert.frame_from_numpy(a["frame"], "cuda"), a


def _stats_rows(path):
    with open(path) as f:
        header, *rows = [line.rstrip("\n").split("\t") for line in f]
    return [dict(zip(header, r)) for r in rows]


def _host_ms(fn, n=5):
    """Median host ms of fn(), synchronized before and after each call."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def run_deform_ladder(el_type, tmp):
    """Part A for one element type: the dual optimization on the deformed
    grid at full width, its gates, and the times of its parts."""
    from orb_slam2_e_tpu_torch.models import deformable as DEF
    from orb_slam2_e_tpu_torch.ops import fem, geometry
    name = f"deform-A el_type {el_type}"
    # the parts, where the system calls them: arguments kept for the timings
    seen = {}
    saved = {"build_mesh": fem.build_mesh, "_ba_solve_nr": DEF._ba_solve_nr,
             "_mode2_solve": DEF._mode2_solve}

    def keep(key):
        def wrapper(*args, **kwargs):
            seen.setdefault(key, (args, kwargs))
            return saved[key](*args, **kwargs)
        return wrapper

    fem.build_mesh = keep("build_mesh")
    DEF._ba_solve_nr = keep("_ba_solve_nr")
    DEF._mode2_solve = keep("_mode2_solve")
    try:
        slam, frame, a = _deformed_system(el_type, True,
                                          os.path.join(tmp, f"A{el_type}.txt"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, ok = slam._relocalize(frame)
        torch.cuda.synchronize()
        reloc_ms = (time.perf_counter() - t0) * 1e3
    finally:
        fem.build_mesh = saved["build_mesh"]
        DEF._ba_solve_nr = saved["_ba_solve_nr"]
        DEF._mode2_solve = saved["_mode2_solve"]
    row = _stats_rows(slam.cfg.stats_reloc_path)[-1]
    stages = [s for s in (1, 2, 3) if row[f"nGoodR_S{s}"] != ""]
    n_r = [int(row[f"nGoodR_S{s}"]) for s in stages]
    n_nr = [int(row[f"nGoodNR_S{s}"]) for s in stages]
    n = a["n"]
    moved = (slam.map.lm_xyz[:n].cpu() - torch.from_numpy(a["pts"])).norm(
        dim=1)
    flagged = slam.map.lm_rigid[:n].cpu() == 2
    print(f"[{name}] {n} landmarks, PnP inliers {row['Inliers_PnP_R']}, "
          f"stages {stages}: nGoodR {n_r}, nGoodNR {n_nr}, accepted "
          f"{row['Accepted']} at S{row['Stage']}; lm_rigid == 2 on "
          f"{int(flagged.sum())}, moved {int((moved > 0).sum())} "
          f"(by more than 0.1 mm: {int((moved > 1e-4).sum())}, farthest "
          f"{float(moved.max()):.4f} m)")
    expect(all(r < RELOC_GOOD for r in n_r), f"{name}: rigid reached the "
           f"bar: {n_r}")
    expect(max(n_nr) >= RELOC_GOOD, f"{name}: non-rigid stayed under the "
           f"bar: {n_nr}")
    expect(ok and row["Accepted"] == "1", f"{name}: not accepted: {row}")
    expect(int((flagged & (moved > 0)).sum()) > n // 2,
           f"{name}: {int((flagged & (moved > 0)).sum())} of {n} landmarks "
           "flagged non-rigid and moved")
    expect(bool(torch.isfinite(out.pose7).all())
           and bool(torch.isfinite(slam.map.lm_xyz).all()),
           f"{name}: pose or map not finite")

    # the same frame with deformable=False: the rigid ladder alone
    rigid, frame_r, _ = _deformed_system(el_type, False,
                                         os.path.join(tmp, f"R{el_type}.txt"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, ok_r = rigid._relocalize(frame_r)
    torch.cuda.synchronize()
    rigid_ms = (time.perf_counter() - t0) * 1e3
    row_r = _stats_rows(rigid.cfg.stats_reloc_path)[-1]
    print(f"[{name}] deformable=False: accepted {row_r['Accepted']} at "
          f"S{row_r['Stage']}, nGoodR "
          f"{[row_r[f'nGoodR_S{s}'] for s in (1, 2, 3)]}")
    expect(not ok_r, f"{name}: the rigid ladder alone relocalized")

    # the parts, timed on the arguments of the run above
    (pts, uv), mesh_kw = seen["build_mesh"]
    cam, prob, mesh, parent_map, w_se = seen["_ba_solve_nr"][0]
    ke = fem.element_stiffness_batch(mesh)
    node_pos = fem.node_positions(mesh, prob.points[parent_map])
    times = {
        "delaunay (host)": _host_ms(lambda: geometry.delaunay(uv)),
        "build_mesh with delaunay (host)": _host_ms(
            lambda: fem.build_mesh(pts, uv, **mesh_kw)),
        "element_stiffness_batch": time_ms(
            lambda: fem.element_stiffness_batch(mesh), n=10, rounds=3),
        "strain_energy": time_ms(
            lambda: fem.strain_energy(mesh, ke, node_pos), n=20, rounds=3),
        "_ba_solve_nr (10 + 10 LM)": _host_ms(
            lambda: DEF._ba_solve_nr(cam, prob, mesh, parent_map, w_se), 3),
    }
    if "_mode2_solve" in seen:
        m2 = seen["_mode2_solve"][0]
        times["_mode2_solve (64 CG)"] = _host_ms(
            lambda: DEF._mode2_solve(*m2), 3)
        print(f"[{name}] mode-2 mesh: {m2[0].u0.shape[0]} node slots, "
              f"{int(m2[0].elem_valid.sum())} elements")
    times["_relocalize deformable=True"] = reloc_ms
    times["_relocalize deformable=False"] = rigid_ms
    print(f"[{name}] mesh: {int(mesh.n_nodes_active)} nodes, "
          f"{int(mesh.elem_valid.sum())} elements of {mesh.elements.shape[0]}"
          f" slots, ke_all {ke.numel() * 4 / 1e6:.1f} MB")
    for key, ms in times.items():
        print(f"[{name}] {key}: {ms:.2f} ms")
    for col in ("timeR_S1", "timeNR_S1"):
        print(f"[{name}] {col} {float(row[col]) * 1e3:.2f} ms (first call)")


def surface_scene():
    """Part B's scene: the orbit's scene with its squares set onto a smooth
    height field, and the field that deforms it."""
    scene, poses, centers = make_scene()
    x, y = scene.xyz[:, 0], scene.xyz[:, 1]
    scene.xyz[:, 2] = 6.5 + 2.0 * np.sin(0.9 * x + 0.3) * np.cos(1.0 * y)
    rest = scene.xyz.copy()
    field = np.stack([0.3 * np.sin(0.9 * y + 1.0),
                      0.3 * np.cos(0.8 * x - 0.5),
                      np.sin(0.7 * x) * np.cos(0.6 * y)], 1).astype(
        np.float32)
    return scene, poses, centers, rest, field


def run_deform_workflow(tmp):
    """Part B: map at rest, save, load into a deformable system, localize
    on the deforming surface with a relocalization after every TP."""
    from orb_slam2_e_tpu_torch.models.system import (SlamSystem,
                                                     SystemConfig, Sensor)
    from orb_slam2_e_tpu_torch.ops.camera import Camera
    from orb_slam2_e_tpu_torch.utils import map_io
    scene, poses, centers, rest, field = surface_scene()
    cam = Camera.create(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2, bf=BF)
    n1, n2 = DEFORM_MAPPED, DEFORM_MAPPED + DEFORM_FRAMES
    slam = SlamSystem(cam, SystemConfig(pipeline=False), Sensor.RGBD,
                      device="cuda")
    inputs = [(grey(scene, R, t), scene.depth_map(R, t))
              for R, t in poses[:n1]]
    r = drive("deform-map", slam, inputs, centers[:n1], with_scale=False)
    launches = r["launches"]
    expect(len(r["tracked"]) >= n1 - 1, f"deform-map tracked {r['tracked']}")
    expect(r["ate"] < ATE_MAX, f"deform-map ATE {r['ate']}")
    slam.shutdown()

    path = os.path.join(tmp, "surface_map.npz")
    save_ms = _host_ms(lambda: slam.save_map(path), 3)
    size = os.path.getsize(path)
    back, extra = map_io.load_map(path, device="cuda")
    for k, v in slam.map._asdict().items():
        got = getattr(back, k)
        expect(got.dtype == v.dtype and torch.equal(got, v),
               f"deform: saved field {k} reads back differently")
    expect(int(extra["n_keyframes"]) == slam.n_keyframes
           and "voc_nodes_packed" in extra, f"deform: extras {sorted(extra)}")

    loc = SlamSystem(cam, SystemConfig(
        pipeline=False, deformable=True, reloc_test_all_frames=True,
        stats_reloc_path=os.path.join(tmp, "B.txt")), Sensor.RGBD,
        device="cuda")
    load_ms = _host_ms(lambda: loc.load_map(path), 3)
    print(f"[deform-io] save_map {save_ms:.1f} ms, load_map {load_ms:.1f} ms "
          f"(with the database refill), file {size} bytes "
          f"({slam.n_keyframes} keyframes, {int(slam.map.lm_valid.sum())} "
          f"landmarks, capacities {slam.map.K} x {slam.map.F}, "
          f"{slam.map.P})")
    expect(loc.n_keyframes == slam.n_keyframes
           and loc.frame_id == slam.frame_id, "deform: counters not loaded")
    loc.activate_localization_mode()
    rest_map = loc.map.lm_xyz.clone()
    inputs = []
    for k, (R, t) in enumerate(poses[n1:n2]):
        scene.xyz = rest + DEFORM_AMPLITUDE * k / (DEFORM_FRAMES - 1) * field
        inputs.append((grey(scene, R, t), scene.depth_map(R, t)))
    r = drive("deform-loc", loc, inputs, centers[n1:n2], with_scale=False,
              first_frame=n1)
    launches += r["launches"]
    rows = _stats_rows(loc.cfg.stats_reloc_path)
    nr_won = [row["Frame"] for row in rows if row["Accepted"] == "1" and any(
        row[f"nGoodNR_S{s}"] not in ("", "-1")
        and int(row[f"nGoodNR_S{s}"]) >= (RELOC_GOOD if s == 3 else 10)
        for s in (1, 2, 3))]
    moved = (loc.map.lm_xyz - rest_map).norm(dim=1)
    for row in rows:
        shown = ", ".join(
            f"{c} {row[c]}" for c in row if c.startswith("nGood")
            or c in ("KF_candidates", "Inliers_PnP_R", "Stage", "Accepted"))
        print(f"[deform-loc] attempt at frame {row['Frame']}: {shown}")
    nr_ms = [float(row[f"timeNR_S{s}"]) * 1e3 for row in rows
             for s in (1, 2, 3) if row[f"timeNR_S{s}"] not in ("", "0.0")]
    print(f"[deform-loc] tracked {len(r['tracked'])} of {DEFORM_FRAMES}, "
          f"relocs {loc.stats['relocs']} of {len(rows)} attempts, kpi "
          f"tp/fp/fn {loc.kpi.tp}/{loc.kpi.fp}/{loc.kpi.fn}, SE3 ATE "
          f"{r['ate']:.4f} m; non-rigid branch won at frames {nr_won}; "
          f"lm_rigid 1 / 2 on {int((loc.map.lm_rigid == 1).sum())} / "
          f"{int((loc.map.lm_rigid == 2).sum())} landmarks, "
          f"{int((moved > 0).sum())} moved, farthest "
          f"{float(moved.max()):.3f} m; timeNR per stage: median "
          f"{statistics.median(nr_ms):.1f} ms over {len(nr_ms)}")
    expect(loc.stats["relocs"] >= DEFORM_REF_RELOCS - DEFORM_SLACK,
           f"deform-loc relocs {loc.stats['relocs']}")
    expect(loc.kpi.tp >= DEFORM_REF_TP - DEFORM_SLACK,
           f"deform-loc kpi.tp {loc.kpi.tp}")
    expect(len(nr_won) >= 1, "deform-loc: the non-rigid branch never won")
    expect(bool((loc.map.lm_rigid == 2).any()) and bool((moved > 0).any()),
           "deform-loc: no landmark was deformed")
    expect(loc.n_keyframes == slam.n_keyframes, "deform-loc inserted a "
           "keyframe")
    expect(bool(torch.isfinite(loc.map.lm_xyz).all()),
           "deform-loc: the map is not finite")
    expect(launches == n2, f"deform launches {launches}")
    return launches


def run_deform():
    """The deformable mode on the card: the dual optimization at full
    width for both element types (no extraction, so no launch), then the
    save / load / relocalize workflow on a deforming surface."""
    import tempfile
    from orb_slam2_e_tpu_torch.ops import geometry, kernels
    t0 = time.perf_counter()
    geometry.build()
    print(f"geometry build: {time.perf_counter() - t0:.2f} s "
          f"(g++ {' '.join(geometry.GXX_FLAGS)})")
    with tempfile.TemporaryDirectory() as tmp:
        kernels.fast_nms_blur.launches = 0
        for el_type in DEFORM_GRIDS:
            run_deform_ladder(el_type, tmp)
        expect(kernels.fast_nms_blur.launches == 0,
               "deform-A extracted a frame")
        return run_deform_workflow(tmp)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    print(card_line())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    import orb_slam2_e_tpu_torch  # noqa: F401  (precision settings)
    scene, poses, centers = make_scene()
    record = check_kernel(grey(scene, *poses[0]))
    if sys.argv[1:] == ["--kernel-only"]:
        print(json.dumps({"kernels": [record]}))
        return 0
    orbit = (scene, poses, centers)

    def phase(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"{fn.__name__}: passed in {time.perf_counter() - t0:.1f} s")
        return out

    n_rgbd, rgbd_state = phase(run_rgbd, *orbit)
    record["launches"] = (
        n_rgbd + phase(run_mono, *orbit) + phase(run_stereo, *orbit)
        + phase(run_reloc, *orbit) + phase(run_loop)
        + phase(run_loc, orbit, rgbd_state) + phase(run_deform))
    # one launch per extraction: 30 + 20 + 2 x 12 + 25 on the orbit, 96
    # around the ring, 10 + 12 + 30 in localization-only mode, 20 + 20 on
    # the deforming surface (none in the deformable phase's part A)
    expect(record["launches"] == 99 + LOOP_FRAMES + LOC_ORBIT_FRAMES
           + LOC_MAPPED + LOC_FRAMES + DEFORM_MAPPED + DEFORM_FRAMES,
           f"launch total {record['launches']}")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(card_line())
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
