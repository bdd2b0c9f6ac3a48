"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernel (and, beside it, the earlier one-level
kernel as a timing baseline) from the sources in this checkout. Holds the kernel
against its plain torch twin on the card: the whole 8-level pyramid of a
640x480 frame in one launch, and two odd shapes through the one-level
entry. Times it by replaying a CUDA graph of back-to-back launches, at level
0 and for the pyramid, beside the baseline, the wrapper's call rate, the
plain version and the card's bound for the same work. Then drives
`SlamSystem` on the card through eight phases on synthetic 640x480 scenes
(8 levels, 1000 features), the parallel package through a ninth and the
real-texture proxy sequences through a tenth, each
through the entry point a user calls, with everything, loop closing
included, at its default unless said:

1. RGB-D, 30 frames of the benchmark's orbit (camera fx=fy=500);
2. monocular, the benchmark's configuration (bench.py), 20 frames;
3. stereo, 10 frames;
4. RGB-D with frame 20 blanked, 25 frames: one LOST frame, relocalized;
5. loop closing: RGB-D, 96 frames on 1.1 turns of a circle looking outward
   at a ring of points (the scene of tests/test_loop_e2e.py at this image
   size). The revisit is detected, the Sim3 passes the ladder, the map is
   corrected and fused, the essential graph optimized, and the global BA
   runs in five chunks behind the frames that follow;
6. localization-only mode: on phase 1's map, 6 more frames of the orbit;
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
   true positive (`reloc_test_all_frames`);
8. a sequence from disk through the example programs. 12 frames of the orbit
   are written as a TUM RGB-D sequence (8-bit grey and 16-bit depth PNG
   files by the package's own writer, an associations file, a settings
   YAML with `DepthMapFactor: 5000.0`); every file is decoded by both PNG
   decoders where libpng built, and the arrays must be equal; then
   `examples.rgbd_tum.main([...])` reads the sequence, tracks it with the
   configuration `SystemConfig.from_settings` gives, and writes
   `CameraTrajectory.txt`, which is read back and held against the orbit.
   Then `examples.mono_deformable.main([... "--save-map" ...])` on 20 grey
   frames of the same directory: its `reloc KPI:` line must parse and the
   map file must load;
9. the parallel package: `BatchedTracker` with 8 lanes on phase 1's map,
   bench.py's lane protocol (staggered starts, bootstrapped from the
   tracked poses, one warm-up and 12 timed steps), every step one kernel
   launch over the 8 pyramids (64 levels, held bit for bit against the
   plain twin lane by lane and timed against its bound) and the tracking
   under torch.vmap; every lane held to the single-lane `track_frame_fused`
   on the same features; the batched and the single-lane rate and the
   launches of a step. Then, on a one-rank NCCL group, the distributed BA
   of phase 1's global BA problem against the single solve, the sharded
   BoW query against the database's, and the dryrun twin;
10. the real-texture proxies (`orb_slam2_e_tpu_torch/tools`): one frame
   each of the TUM room, the breathing endoscopy surface, the KITTI and
   the distorted EuRoC cameras rendered on the card and on the CPU by the
   same code, held to each other; the endoscopy configuration's pyramid (6
   levels at scale 1.1 from 480x360) through the kernel, bit for bit
   against the plain twin; then 40 frames of proxy_xyz rendered on the
   card by `make_proxy_dataset.main` and tracked by `run_proxy_eval.main`
   through `examples.rgbd_tum` and `examples.mono_tum`, at the JAX
   package's end-to-end gates, beside the reference's numbers on the same
   files.

Each phase checks tracking, trajectory error, its own gates and that every
extraction went through the kernel in exactly one launch (the launch count
is zeroed before the phase and read after it; in phase 9 one launch per
step for all lanes). Prints per-stage median ms, each phase's seconds and
the total,
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
DISK_FRAMES = 12         # the sequence on disk that rgbd_tum reads
DISK_MONO_FRAMES = 20    # grey frames of it that mono_deformable reads
DEPTH_FACTOR = 5000.0    # TUM's: 16-bit depth counts per metre
LOC_ORBIT_FRAMES = 6     # localization-only frames on the RGB-D phase's map
STEREO_FRAMES = 10
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
# the parallel phase: bench.py's lanes (B = 8, staggered starts, one
# warm-up and PAR_STEPS timed steps) on the RGB-D phase's map
PAR_LANES, PAR_STEPS = 8, 12
# the tenth phase: the real-texture proxies of orb_slam2_e_tpu_torch/tools
PROXY_FRAMES = 40        # frames of proxy_xyz (all four textures) tracked
# a card render against the CPU's: grey levels and metres apart, as
# tests/test_torch_proxy_render.py measures the port against the reference
# on the CPU (tests/_torch_proxy.py: equal, bit for bit)
PROXY_RENDER_MAX = 0
PROXY_DEPTH_ATOL = 0.0
# the reference (examples/rgbd_tum.py and mono_tum.py of the JAX package,
# on the CPU) on the same 40 files: ATE in metres, frames in the trajectory
# file, the frame mono initialized at
PROXY_REF = {"rgbd": {"ate": 0.0061, "tracked": 40},
             "mono": {"ate": 0.0200, "tracked": 34, "init": 6}}
# batched lane vs single-lane step on the same features: flags equal, poses
# within this (the pose LM sums in another order under torch.vmap)
PAR_POSE_ATOL = 1e-4
# ... and at most this share of the visibility decisions (a landmark seen or
# matched in a step) flipped: on the card a pose 1e-5 apart can move a
# landmark across the frustum's border or a match across its threshold
PAR_FLIP_SHARE = 1e-3
# batched vs one-image resize of a level (0..255 grey): a few float32 ulps
PAR_RESIZE_ATOL = 1e-3
# distributed BA vs the single solve on one rank (tests/test_parallel.py)
DIST_POSE_ATOL, DIST_POINT_ATOL = 5e-4, 5e-3
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
        offsets = kernels.pyramid_layout([tuple(i.shape)
                                          for i in sets[0][0]])[0]

        def enqueue(i):
            imgs, out = sets[i % len(sets)]
            kernels.launch_into(imgs, out[0], out[1], TH_HIGH, TH_LOW,
                                offsets)
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


def run_stereo(scene, poses, centers, n_frames=STEREO_FRAMES):
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

    # every Sim3 attempt's counts: compute_sim3's inliers, then, where it
    # passed, verify_sim3's inliers and projected matches, then, where the
    # loop closed, the landmarks fused
    attempts = []

    def timed(key):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = saved[key](*args, **kwargs)
            torch.cuda.synchronize()
            part_ms[key].append((time.perf_counter() - t0) * 1e3)
            if key == "compute_sim3":
                attempts.append({"frame": slam.frame_id, "kf": int(args[3]),
                                 "loop_kf": int(args[4]),
                                 "n_in": int(out[3])})
            elif key == "verify_sim3":
                attempts[-1].update(n_in2=int(out[3]), n_total=int(out[4]))
            elif key == "search_and_fuse":
                attempts[-1]["n_fused"] = int(out[1])
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
    for a in attempts:
        print(f"[loop] Sim3 attempt behind frame {a['frame']}: keyframe "
              f"{a['kf']} -> {a['loop_kf']}: n_in {a['n_in']}, n_in2 "
              f"{a.get('n_in2', '-')}, n_total {a.get('n_total', '-')}, "
              f"fused {a.get('n_fused', '-')} "
              f"({'closed' if 'n_fused' in a else 'rejected'})")
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


DISK_SETTINGS = f"""%YAML:1.0
# camera of the benchmark orbit, in the cv::FileStorage form of a TUM file
Camera.fx: {FX}
Camera.fy: {FX}
Camera.cx: {WIDTH / 2}
Camera.cy: {HEIGHT / 2}
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.k3: 0.0
Camera.width: {WIDTH}
Camera.height: {HEIGHT}
Camera.fps: 30.0
Camera.RGB: 1
Camera.bf: {BF}
ThDepth: 35.0
DepthMapFactor: {DEPTH_FACTOR}
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def write_tum_sequence(root, scene, poses):
    """A TUM RGB-D sequence of the orbit under `root`: rgb/ (8-bit grey),
    depth/ (16-bit, DEPTH_FACTOR counts per metre) for the first
    DISK_FRAMES frames, rgb.txt over DISK_MONO_FRAMES grey frames,
    associations.txt and settings.yaml. Returns the written PNG paths and
    the ms the writer took per file."""
    from orb_slam2_e_tpu_torch.utils import imageio
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    rgb_lines, assoc, paths, write_ms = [], [], [], []

    def write(rel, img):
        t0 = time.perf_counter()
        imageio.write_png(os.path.join(root, rel), img)
        write_ms.append((time.perf_counter() - t0) * 1e3)
        paths.append(os.path.join(root, rel))

    for k, (R, t) in enumerate(poses[:DISK_MONO_FRAMES]):
        ts = f"{k / 30.0:.6f}"
        write(f"rgb/{ts}.png", grey(scene, R, t))
        rgb_lines.append(f"{ts} rgb/{ts}.png")
        if k < DISK_FRAMES:
            counts = np.round(scene.depth_map(R, t) * DEPTH_FACTOR)
            expect(counts.max() < 65536, "depth does not fit 16 bits")
            write(f"depth/{ts}.png", counts.astype(np.uint16))
            assoc.append(f"{ts} rgb/{ts}.png {ts} depth/{ts}.png")
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("# timestamp filename\n" + "\n".join(rgb_lines) + "\n")
    with open(os.path.join(root, "associations.txt"), "w") as f:
        f.write("\n".join(assoc) + "\n")
    with open(os.path.join(root, "settings.yaml"), "w") as f:
        f.write(DISK_SETTINGS)
    return paths, statistics.median(write_ms)


def check_png_backends(paths):
    """Which decoder `"auto"` takes; where libpng built, both decoders on
    every written file, arrays equal; decode ms per file of each."""
    from orb_slam2_e_tpu_torch.utils import imageio
    name, why = imageio.auto_backend()
    why = " ".join(why.split())[:300]    # the compiler's message on one line
    print(f"[disk] PNG backend \"auto\": {name} ({why})")
    backends = ("libpng", "numpy") if name == "libpng" else ("numpy",)
    ms = {b: {"gray8": [], "u16": []} for b in backends}
    for path in paths:
        kind = "u16" if os.sep + "depth" + os.sep in path else "gray8"
        read = imageio.read_u16 if kind == "u16" else imageio.read_gray8
        got = []
        for b in backends:
            t0 = time.perf_counter()
            got.append(read(path, b))
            ms[b][kind].append((time.perf_counter() - t0) * 1e3)
        expect(got[0].shape == (HEIGHT, WIDTH), f"{path}: {got[0].shape}")
        expect(all(g.dtype == got[0].dtype and np.array_equal(g, got[0])
                   for g in got[1:]), f"PNG decoders disagree on {path}")
    for b in backends:
        print(f"[disk] decode {b}: 8-bit grey "
              f"{statistics.median(ms[b]['gray8']):.2f} ms, 16-bit depth "
              f"{statistics.median(ms[b]['u16']):.2f} ms per {WIDTH}x{HEIGHT} "
              f"file (median of {len(ms[b]['gray8'])} / {len(ms[b]['u16'])})")
    return name


def run_disk(scene, poses, centers):
    """A sequence on disk through the example programs: what a user of the
    package runs. Returns the launches of both examples."""
    import contextlib
    import io
    import re
    import tempfile
    from orb_slam2_e_tpu_torch.examples import mono_deformable, rgbd_tum
    from orb_slam2_e_tpu_torch.ops import kernels
    from orb_slam2_e_tpu_torch.utils import map_io
    from orb_slam2_e_tpu_torch.utils.trajectory import ate_rmse, load_tum
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        seq, work = os.path.join(tmp, "seq"), os.path.join(tmp, "work")
        os.makedirs(work)
        t0 = time.perf_counter()
        paths, write_ms = write_tum_sequence(seq, scene, poses)
        print(f"[disk] wrote {len(paths)} PNG files in "
              f"{time.perf_counter() - t0:.2f} s (rendering included; the "
              f"writer: median {write_ms:.2f} ms per file)")
        check_png_backends(paths)
        settings = os.path.join(seq, "settings.yaml")
        os.chdir(work)                   # the examples write where they run
        try:
            # --- rgbd_tum
            kernels.fast_nms_blur.launches = 0
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                slam = rgbd_tum.main([settings, seq, os.path.join(
                    seq, "associations.txt"), "--device", "cuda"])
            wall = time.perf_counter() - t0
            n_rgbd = kernels.fast_nms_blur.launches
            print("".join(f"[disk] rgbd_tum> {ln}\n"
                          for ln in out.getvalue().splitlines()), end="")
            ts, twc, _ = load_tum("CameraTrajectory.txt")
            frames = np.round(ts * 30.0).astype(int)
            ate = ate_rmse(twc, centers[frames].astype(np.float64), False)
            off_card = [k for k, v in slam.map._asdict().items()
                        if v.device.type != "cuda"]
            off_card += [f"cam.{k}" for k, v in slam.cam._asdict().items()
                         if v.device.type != "cuda"]
            off_card += [f"last_frame.{k}" for k, v in
                         slam.last_frame._asdict().items()
                         if v.device.type != "cuda"]
            print(f"[disk] rgbd_tum: {len(ts)} of {DISK_FRAMES} frames in "
                  f"CameraTrajectory.txt, keyframes {slam.n_keyframes}, "
                  f"landmarks {int(slam.map.lm_valid.sum())}, SE3 ATE "
                  f"{ate:.4f} m, {wall:.2f} s with the files' decoding = "
                  f"{DISK_FRAMES / wall:.2f} frames/s, launches {n_rgbd}; "
                  f"capacities {slam.map.K} / {slam.map.P}, "
                  f"depth_map_factor {slam.cfg.depth_map_factor:.6g}")
            expect(f"Images in the sequence: {DISK_FRAMES}" in out.getvalue(),
                   "rgbd_tum did not print its sequence line")
            expect(len(ts) == DISK_FRAMES, f"disk tracked {len(ts)}")
            expect(ate < ATE_MAX, f"disk ATE {ate}")
            expect(not off_card, f"disk: tensors off the card: {off_card}")
            expect((slam.map.K, slam.map.P) == (256, 24576),
                   "disk: not the default capacities")
            expect(n_rgbd == DISK_FRAMES, f"disk launches {n_rgbd}")
            expect(os.path.getsize("KeyFrameTrajectory.txt") > 0,
                   "rgbd_tum wrote no keyframe trajectory")
            expect("jax" not in sys.modules, "jax was imported")

            # --- mono_deformable on the grey frames, with --save-map
            kernels.fast_nms_blur.launches = 0
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                mono = mono_deformable.main(
                    [settings, seq, "--save-map", "map.npz", "--stats",
                     "StatsReloc.txt", "--device", "cuda"])
            wall = time.perf_counter() - t0
            n_mono = kernels.fast_nms_blur.launches
            print("".join(f"[disk] mono_deformable> {ln}\n"
                          for ln in out.getvalue().splitlines()), end="")
            kpi = re.search(r"^reloc KPI: TP=(\d+) FP=(\d+) FN=(\d+) "
                            r"precision=([\d.]+) recall=([\d.]+)$",
                            out.getvalue(), re.M)
            expect(kpi is not None, "mono_deformable: no reloc KPI line")
            back, extra = map_io.load_map("map.npz", device="cuda")
            tracked = sum(p7 is not None for _, p7 in mono.trajectory)
            print(f"[disk] mono_deformable: {DISK_MONO_FRAMES} frames in "
                  f"{wall:.2f} s, tracked {tracked}, keyframes "
                  f"{mono.n_keyframes}, kpi tp/fp/fn "
                  f"{'/'.join(kpi.groups()[:3])}, map file "
                  f"{os.path.getsize('map.npz')} bytes, launches {n_mono}")
            expect(mono.cfg.deformable, "mono_deformable: not deformable")
            expect(int(extra["n_keyframes"]) == mono.n_keyframes
                   and (back.K, back.P) == (mono.map.K, mono.map.P),
                   "mono_deformable: the saved map reads back differently")
            expect(n_mono == DISK_MONO_FRAMES, f"disk mono launches {n_mono}")
        finally:
            os.chdir(cwd)
    return n_rgbd + n_mono


def _lane_feats(feats, b):
    return type(feats)(*(v[b] for v in feats))


def time_batch_kernel(lanes):
    """The 64-level launch of the 8 lanes' pyramids against the plain twin
    lane by lane, then its replay time beside 8 one-pyramid launches and
    its bound. Returns the JSON fields."""
    from orb_slam2_e_tpu_torch.ops import kernels
    got = kernels.fast_nms_blur_batch(lanes, TH_HIGH, TH_LOW)
    max_err = 0.0
    for b, levels in enumerate(lanes):
        want = kernels.fast_nms_blur_pyramid_plain(levels, TH_HIGH, TH_LOW)
        for lvl, ((score, blur), (ws, wb)) in enumerate(zip(got, want)):
            err = (blur[b] - wb).abs().max().item()
            expect(torch.equal(score[b], ws) and err <= BLUR_TOL,
                   f"batch launch disagrees with plain: lane {b} level {lvl}")
            max_err = max(max_err, err)
    flat = [img for levels in lanes for img in levels]
    shapes = [tuple(img.shape) for img in lanes[0]]
    offsets, total = kernels.batch_layout(shapes, len(lanes))
    offsets = tuple(offsets[lvl][b] for b in range(len(lanes))
                    for lvl in range(len(shapes)))
    batch_out = torch.empty((2, total), dtype=torch.float32, device="cuda")
    pyr_offsets, pyr_total = kernels.pyramid_layout(shapes)
    lane_out = [torch.empty((2, pyr_total), dtype=torch.float32,
                            device="cuda") for _ in lanes]

    def batch(_):
        kernels.launch_into(flat, batch_out[0], batch_out[1], TH_HIGH,
                            TH_LOW, offsets)

    def eight(_):
        for levels, out in zip(lanes, lane_out):
            kernels.launch_into(levels, out[0], out[1], TH_HIGH, TH_LOW,
                                pyr_offsets)

    times = {"eight": [], "batch": []}
    for who, fn in (("eight", eight), ("batch", batch), ("batch", batch),
                    ("eight", eight)):
        times[who].append(replay_ms(fn))
    raw = [kernels.fast_score_map(img, TH_HIGH, TH_LOW) for img in flat]
    bound, by, _, counts = bound_ms(flat, raw)
    ms, eight_ms = min(times["batch"]), min(times["eight"])
    print(f"[parallel] {len(flat)}-level launch ({len(lanes)} lanes x "
          f"{len(shapes)} levels): replay {times['batch'][0]:.5f} / "
          f"{times['batch'][1]:.5f} ms; 8 one-pyramid launches "
          f"{times['eight'][0]:.5f} / {times['eight'][1]:.5f} ms; bound "
          f"{bound:.5f} ms by {by} ({json.dumps(counts)}): the launch "
          f"reaches {bound / ms:.1%} of it; bit-equal to the plain twin "
          f"lane by lane (blur max|diff| {max_err:.3g})")
    return {"batch64_ms": ms, "batch64_bound_ms": bound,
            "batch64_bound_by": by, "eight_pyramid_launches_ms": eight_ms}


def run_parallel(orbit, rgbd_state):
    """The parallel package on the card. (a) `BatchedTracker`, B = 8, on
    the RGB-D phase's map by bench.py's lane protocol: each step one kernel
    launch for the 8 pyramids and the tracking under torch.vmap; every lane
    held to the single-lane `track_frame_fused` on the same features; the
    batched and the single-lane rate, the launches and synchronizing calls
    of a step, the 64-level launch's time against its bound. (b) the
    distributed BA on a one-rank NCCL group (one card cannot host two) on
    the map's global BA problem, against the single solve; (c) the sharded
    BoW query against the database's own; (d) the dryrun twin. Returns the
    phase's launches of the main path and the kernel record's fields."""
    import tempfile
    import torch.distributed as dist
    from orb_slam2_e_tpu_torch.models import kf_database as KFDB
    from orb_slam2_e_tpu_torch.models import loop_closing as LC
    from orb_slam2_e_tpu_torch.models import tracking as T
    from orb_slam2_e_tpu_torch.models.frame import frame_from_features
    from orb_slam2_e_tpu_torch.ops import ba, kernels, lie
    from orb_slam2_e_tpu_torch.parallel import dist_ba, dist_db
    from orb_slam2_e_tpu_torch.parallel.batched import BatchedTracker
    from orb_slam2_e_tpu_torch.tools import dryrun_multichip as dry
    from orb_slam2_e_tpu_torch.tools.profile_step import profile_frames
    scene, poses, _ = orbit
    slam, _, _ = rgbd_state
    B, n_steps = PAR_LANES, PAR_STEPS + 1          # one warm-up step
    n = len(slam.trajectory)                       # frames the map tracked
    starts = [n - 1 - PAR_STEPS - b for b in range(B)]
    rendered = {}

    def image(k):
        if k not in rendered:
            rendered[k] = grey(scene, *poses[k])
        return rendered[k]

    batches = [torch.as_tensor(np.stack([image(st + 1 + k) for st in starts]),
                               device="cuda") for k in range(n_steps)]
    ref_kf = max(slam.last_kf_slot, 0)
    refs = torch.full((B,), ref_kf, dtype=torch.int32, device="cuda")
    cfg = slam.cfg

    # --- (a) the batched tracker: the main path of this phase
    kernels.fast_nms_blur.launches = 0
    boot = []
    for st in starts:
        pose7 = slam.trajectory[st][1]
        expect(pose7 is not None, f"parallel: frame {st} was not tracked")
        boot.append(frame_from_features(slam.cam, slam.extractor(
            torch.as_tensor(image(st), device="cuda")))._replace(pose7=pose7))
    bt = BatchedTracker(slam.cam, slam.track_cfg, [slam.map] * B,
                        n_features=cfg.n_features,
                        scale_factor=cfg.scale_factor, n_levels=cfg.n_levels,
                        device="cuda")
    bt.bootstrap(boot)
    n_boot = kernels.fast_nms_blur.launches
    expect(n_boot == B, f"parallel: {n_boot} launches for {B} boot frames")
    feats_seen = []
    extract_batch = bt.extractor.extract_batch

    def logged(images):
        feats = extract_batch(images)
        feats_seen.append(feats)
        return feats

    bt.extractor.extract_batch = logged
    steps = []

    def batched_step(k):
        ok, n_in = bt.step(batches[k], refs)
        steps.append((ok, n_in, bt.last_frames.pose7, bt.vels,
                      bt.state.lm_visible, bt.state.lm_found))

    kernels.fast_nms_blur.launches = 0
    batched_step(0)                                # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(1, n_steps):
        batched_step(k)
    torch.cuda.synchronize()
    batched_s = time.perf_counter() - t0
    batched_fps = B * PAR_STEPS / batched_s
    n_batched = kernels.fast_nms_blur.launches
    expect(n_batched == n_steps, f"parallel: {n_batched} launches for "
           f"{n_steps} batched steps of {B} lanes")

    # every lane against the single-lane step on the same features; a
    # landmark's visible / found increment of one step is a decision, and
    # a decision "flips" where the lane and the single step disagree
    t0 = time.perf_counter()
    worst_pose, flip_pose, flips, flip_steps, decisions = 0.0, 0.0, 0, 0, 0
    for b in range(B):
        state, last = slam.map, boot[b]
        vel, have_vel = lie.pose7_identity(device="cuda"), False
        counts_b = (slam.map.lm_visible, slam.map.lm_found)
        for k in range(n_steps):
            frame = frame_from_features(slam.cam,
                                        _lane_feats(feats_seen[k], b))
            counts_s = (state.lm_visible, state.lm_found)
            state, last, vel, flags = T.track_frame_fused(
                slam.cam, slam.track_cfg, state, frame, last, vel, have_vel,
                ref_kf)
            ok, n_in, pose7, vels, vis, found = steps[k]
            flags = flags.tolist()
            have_vel = bool(flags[0])
            expect(bool(ok[b]) and flags[0] == 1, f"parallel: lane {b} lost "
                   f"at step {k}: batched {bool(ok[b])}, single {flags}")
            expect(int(n_in[b]) == flags[1], f"parallel: lane {b} step {k}: "
                   f"{int(n_in[b])} inliers batched, {flags[1]} single")
            pose_diff = max(float((pose7[b] - last.pose7).abs().max()),
                            float((vels[b] - vel).abs().max()))
            step_s = [new - old for new, old in zip(
                (state.lm_visible, state.lm_found), counts_s)]
            step_b = [new - old for new, old in zip((vis[b], found[b]),
                                                    counts_b)]
            counts_b = (vis[b], found[b])
            n_flip = sum(int((x != y).sum()) for x, y in zip(step_s, step_b))
            decisions += sum(int((x != 0).sum()) for x in step_s)
            flips += n_flip
            flip_steps += n_flip > 0
            worst_pose = max(worst_pose, pose_diff)
            if n_flip:
                flip_pose = max(flip_pose, pose_diff)
    torch.cuda.synchronize()
    yardstick_s = time.perf_counter() - t0
    print(f"[parallel] {B} lanes x {n_steps} steps: flags equal to the "
          f"single-lane step on the same features, every lane tracked; pose "
          f"and velocity max|diff| {worst_pose:.3g} (gate {PAR_POSE_ATOL}), "
          f"{flip_pose:.3g} on the steps with a flipped decision; visibility "
          f"decisions flipped: {flips} of {decisions} on {flip_steps} of "
          f"{B * n_steps} lane steps (gate {PAR_FLIP_SHARE:.0e} of them)")
    expect(worst_pose <= PAR_POSE_ATOL, f"parallel: poses differ by "
           f"{worst_pose}")
    expect(flips <= PAR_FLIP_SHARE * decisions, f"parallel: {flips} of "
           f"{decisions} visibility decisions differ from the single lane's")
    # the single-lane rate: one lane, extraction included, the flags read
    # after every step as the system reads them
    state, last = slam.map, boot[0]
    vel, have_vel = lie.pose7_identity(device="cuda"), False

    def single_step(k):
        nonlocal state, last, vel, have_vel
        frame = frame_from_features(slam.cam, slam.extractor(batches[k][0]))
        state, last, vel, flags = T.track_frame_fused(
            slam.cam, slam.track_cfg, state, frame, last, vel, have_vel,
            ref_kf)
        have_vel = bool(flags[0])

    kernels.fast_nms_blur.launches = 0
    single_step(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(1, n_steps):
        single_step(k)
    torch.cuda.synchronize()
    single_fps = PAR_STEPS / (time.perf_counter() - t0)
    n_single = kernels.fast_nms_blur.launches
    expect(n_single == n_steps, f"parallel: {n_single} launches for "
           f"{n_steps} single-lane steps")
    dev = torch.device("cuda")
    kernels.fast_nms_blur.launches = 0
    pb = profile_frames(lambda i: batched_step(n_steps - 1), 1, dev, 0)
    p1 = profile_frames(lambda i: single_step(n_steps - 1), 1, dev, 0)
    n_prof = kernels.fast_nms_blur.launches
    expect(n_prof == 2, f"parallel: {n_prof} launches for 2 profiled steps")
    launches = n_boot + n_batched + n_single + n_prof
    print(f"[parallel] {card_line()}: batched {batched_fps:.2f} frames/s "
          f"({B} lanes x {PAR_STEPS} steps in {batched_s:.2f} s, "
          f"{batched_s / PAR_STEPS * 1e3:.1f} ms a step); single lane "
          f"{single_fps:.2f} frames/s; the same-feature check took "
          f"{yardstick_s:.1f} s")
    print(f"[parallel] one batched step ({B} lanes, under the profiler): "
          f"{pb['launches']:.0f} kernel launches, {pb['copies']:.0f} copies, "
          f"{pb['syncs']:.0f} synchronizing calls, device busy "
          f"{pb['busy_ms']:.1f} ms; one single-lane step: "
          f"{p1['launches']:.0f} launches, {p1['copies']:.0f} copies, "
          f"{p1['syncs']:.0f} synchronizing calls, busy {p1['busy_ms']:.1f} "
          f"ms; {B} single-lane steps would launch {B * p1['launches']:.0f}")
    print(f"[parallel] fast_nms_blur launches: {n_batched} for {n_steps} "
          f"batched steps of {B} lanes; {n_boot} boot frames, {n_single} "
          f"single-lane steps, {n_prof} profiled steps")
    # the batched extraction against the one-image extraction, every lane
    # of step 0 (comparison launches, not counted). The batched resize is
    # one matmul for all lanes, which cuBLAS may round apart from the
    # one-image matmul: it is held to PAR_RESIZE_ATOL, and everything after
    # it (the kernel and the vmapped detect / angle / descriptor stages) to
    # the one-image stages on the batched levels, exactly
    ex = slam.extractor
    pyr = bt.extractor._pyramid(batches[0])
    resize_err, exact, moved = [0.0] * len(pyr), 0, []
    fields = {f: 0 for f in type(feats_seen[0])._fields}
    for b in range(B):
        lane = _lane_feats(feats_seen[0], b)
        levels = [lvl[b] for lvl in pyr]
        for lvl, (got, want) in enumerate(zip(levels,
                                              ex._pyramid(batches[0][b]))):
            resize_err[lvl] = max(resize_err[lvl],
                                  float((got - want).abs().max()))
        maps = kernels.fast_nms_blur_pyramid(levels, ex.ini_th, ex.min_th)
        per_level = [ex._level_features(lvl, img, smap, blurred)
                     for lvl, (img, (smap, blurred)) in enumerate(zip(levels,
                                                                     maps))]
        exact += all(torch.equal(getattr(lane, f),
                                 torch.cat([getattr(x, f) for x in per_level]))
                     for f in fields)
        one = ex(batches[0][b])
        for f in fields:
            fields[f] += torch.equal(getattr(one, f), getattr(lane, f))
        moved.append(int((one.uv != lane.uv).any(-1).sum()))
    print(f"[parallel] extract_batch on the card: the batched resize against "
          f"the one-image one, max|diff| by level "
          f"{[f'{e:.3g}' for e in resize_err]} (gate {PAR_RESIZE_ATOL}); on "
          f"the batched levels, every field equal to the one-image stages in "
          f"{exact} of {B} lanes; against the whole one-image extraction, "
          f"lanes equal by field {fields}, keypoint slots that moved by lane "
          f"{moved} of {one.uv.shape[0]}")
    expect(resize_err[0] == 0 and max(resize_err) <= PAR_RESIZE_ATOL,
           f"parallel: batched resize differs by {resize_err}")
    expect(exact == B, "parallel: the batched extraction's stages differ "
           "from the one-image stages on the same levels")
    record = time_batch_kernel(
        [[lvl[b] for lvl in bt.extractor._pyramid(batches[0])]
         for b in range(B)])

    # --- (b)-(d) the distributed modules on a one-rank NCCL group
    with tempfile.TemporaryDirectory() as tmp:
        dry.init_rank(0, 1, os.path.join(tmp, "rdv"), "cuda")
        try:
            prob, clipped = LC.gba_problem(slam.cam, slam.map,
                                           cfg.scale_factor)
            n_obs = int(prob.obs_valid.sum())
            group = dist_ba.make_mesh()

            def solve(sharded):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = (dist_ba.distributed_ba(slam.cam, prob, group, 10, 30)
                       if sharded else
                       ba.ba_solve_pcg(slam.cam, prob, n_outer=10,
                                       cg_iters=30))
                torch.cuda.synchronize()
                return res, (time.perf_counter() - t0) * 1e3

            def diff(a, b):
                return (float((a.cam_pose7 - b.cam_pose7).abs().max()),
                        float((a.points - b.points).abs().max()))

            # the gate: with deterministic scatter-adds (any op without a
            # deterministic kernel raises), the one-rank sharded solve does
            # the single solve's arithmetic, so only the sharding code can
            # make them differ
            dist.all_reduce(torch.zeros(1, device="cuda"))  # start NCCL
            # torch refuses cuBLAS in deterministic mode unless this names a
            # fixed workspace; on one stream cuBLAS repeats bit for bit
            os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
            torch.use_deterministic_algorithms(True)
            try:
                single, det_single_ms = solve(False)
                shard, det_shard_ms = solve(True)
            finally:
                torch.use_deterministic_algorithms(False)
            dp, dx = diff(shard, single)
            # the card's default atomic adds: three solves of each kind,
            # interleaved, every pair compared within and across the kinds
            runs = {False: [], True: []}
            for _ in range(3):
                for sharded in (False, True):
                    runs[sharded].append(solve(sharded))
            single_ms = min(ms for _, ms in runs[False])
            shard_ms = min(ms for _, ms in runs[True])

            def spread(pairs):
                return sorted(diff(a, b)[1] for a, b in pairs)

            s_runs, d_runs = ([r for r, _ in runs[k]] for k in (False, True))
            within_s = spread([(s_runs[i], s_runs[j]) for i in range(3)
                               for j in range(i)])
            within_d = spread([(d_runs[i], d_runs[j]) for i in range(3)
                               for j in range(i)])
            across = spread([(a, b) for a in s_runs for b in d_runs])
            # where the largest of all these differences lies: its point's
            # live observations against the map's median
            d_pts = torch.stack([r.points for r in s_runs + d_runs])
            worst = int((d_pts.amax(0) - d_pts.amin(0)).amax(1).argmax())
            n_seen = torch.bincount(prob.obs_point[prob.obs_valid].long(),
                                    minlength=prob.points.shape[0])
            live = n_seen[prob.point_valid]
            print(f"[parallel] distributed BA, 1 NCCL rank, the map's global "
                  f"BA ({int(slam.map.kf_valid.sum())} keyframes, "
                  f"{int(prob.point_valid.sum())} landmarks, {n_obs} of "
                  f"{prob.obs_valid.shape[0]} observation slots, clipped "
                  f"{int(clipped)}; 10 LM x 30 CG). Deterministic adds: "
                  f"sharded {det_shard_ms:.1f} ms, single {det_single_ms:.1f} "
                  f"ms, max|diff| poses {dp:.3g}, points {dx:.3g}. The card's "
                  f"atomic adds, best of 3 interleaved: sharded "
                  f"{shard_ms:.1f} ms, single {single_ms:.1f} ms; points "
                  f"max|diff| single vs single "
                  f"{[f'{v:.3g}' for v in within_s]}, sharded vs sharded "
                  f"{[f'{v:.3g}' for v in within_d]}, sharded vs single "
                  f"{[f'{v:.3g}' for v in across]}; the most spread point "
                  f"has {int(n_seen[worst])} observations (median "
                  f"{float(live.float().median()):.0f}, min {int(live.min())})"
                  f"; inliers {int(shard.obs_inlier.sum())} / "
                  f"{int(single.obs_inlier.sum())}")
            expect(dp <= DIST_POSE_ATOL and dx <= DIST_POINT_ATOL,
                   f"distributed BA differs: {dp}, {dx}")
            expect(shard.obs_inlier.shape == single.obs_inlier.shape,
                   "distributed BA: obs_inlier not gathered")

            q = slam._bow_vec(slam.map.kf_desc[ref_kf],
                              slam.map.kf_kp_valid[ref_kf])
            want_i, want_s = KFDB.detect_relocalization_candidates(
                slam.bow_db, q, 5)
            vecs, filled = dist_db.pad_rows(slam.bow_db.vecs,
                                            slam.bow_db.filled, 1)
            got_i, got_s = dist_db.sharded_query(group, vecs, filled, q, 5)
            print(f"[parallel] sharded query over ({tuple(vecs.shape)}) "
                  f"tf-idf rows: slots {got_i.tolist()}, database's "
                  f"{want_i.tolist()}")
            expect(torch.equal(got_i, want_i) and float(
                (got_s - want_s).abs().max()) <= 1e-6,
                   "sharded query differs from the database's")
            dry.dryrun_multichip(1, "cuda")
            print("[parallel] dryrun_multichip(1): finite, equal to the "
                  "single-process functions")
        finally:
            dist.destroy_process_group()
    expect("jax" not in sys.modules, "jax was imported")
    return launches, record


def check_proxy_render():
    """One frame of each proxy scene rendered on the card and on the CPU by
    the same code: the TUM room (640x480, 11 planes), the endoscopy surface
    (480x360, 117 quads breathing at amplitude 0.12), the KITTI camera
    (640x256) and the distorted EuRoC rays (512x384). Returns the endo
    frame rendered on the card."""
    from orb_slam2_e_tpu_torch.tools import (make_proxy_dataset as mpd,
                                             make_proxy_endo as mpe,
                                             make_proxy_euroc as mpu,
                                             make_proxy_kitti as mpk,
                                             proxy_render as pr)
    t0 = time.perf_counter()
    (R, t), = mpd.trajectory("xyz", 21)[0][20:]
    room = pr.build_room(0)
    (Re, te), = mpe._trajectory(31, "reloc")[0][30:]
    endo = mpe._make_patches(mpe._surface_points(0.12, 30 / mpe.FPS, 5),
                             mpe._patch_textures(5))
    (Rk, tk), = mpk.forward_trajectory(31)[0][30:]
    (Ru, tu), = mpd.trajectory("xyz", 11)[0][10:]
    dirs = mpu._inverse_distort_dirs()
    kitti_room, euroc_room = pr.build_room(1), pr.build_room(2)
    print(f"[proxy] textures and scenes built in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    cases = {
        "room 640x480": lambda dev: pr.render(room, R, t, device=dev),
        "endo 480x360": lambda dev: pr.render(
            endo, Re, te, near=mpe.NEAR, far=mpe.FAR, size=(mpe.W, mpe.H),
            intrinsics=(mpe.FX, mpe.FY, mpe.CX, mpe.CY), device=dev),
        "kitti 640x256": lambda dev: pr.render(
            kitti_room, Rk, tk, size=(mpk.W, mpk.H),
            intrinsics=(mpk.FX, mpk.FY, mpk.CX, mpk.CY), device=dev),
        "euroc 512x384": lambda dev: pr.render(euroc_room, Ru, tu,
                                               dirs=dirs, device=dev)}
    endo_img = None
    for name, fn in cases.items():
        fn("cuda")                        # the packed textures go up once
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img_g, dep_g = fn("cuda")         # returns host arrays: synchronized
        ms_g = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        img_c, dep_c = fn("cpu")
        ms_c = (time.perf_counter() - t0) * 1e3
        d = np.abs(img_g.astype(np.int16) - img_c.astype(np.int16))
        share = float((d > 0).mean())
        dd = float(np.abs(dep_g - dep_c).max())
        print(f"[proxy] render {name}: card {ms_g:.1f} ms, CPU {ms_c:.1f} "
              f"ms (host clocks); grey levels apart at most {int(d.max())} "
              f"on {share:.2e} of the pixels, depth at most {dd:.3e} m "
              f"apart, hit masks equal: "
              f"{bool(np.array_equal(dep_g > 0, dep_c > 0))}")
        expect(int(d.max()) <= PROXY_RENDER_MAX, f"proxy render {name}: "
               f"{int(d.max())} grey levels on {share:.2e} of the pixels")
        expect(dd <= PROXY_DEPTH_ATOL, f"proxy render {name}: depth {dd}")
        if name.startswith("endo"):
            endo_img = img_g
    return endo_img


def check_endo_pyramid(img):
    """The endoscopy configuration's pyramid (6 levels at scale 1.1 from
    480x360, FAST thresholds 24 / 7) through the kernel in one launch,
    against the plain twin."""
    from orb_slam2_e_tpu_torch.ops import kernels, orb
    from orb_slam2_e_tpu_torch.tools import make_proxy_endo as mpe
    ex = orb.OrbExtractor(n_features=1200, scale_factor=1.1, n_levels=6,
                          ini_th_fast=24, min_th_fast=7)
    levels = ex._pyramid(torch.as_tensor(img, device="cuda"))
    expect(levels[0].shape == (mpe.H, mpe.W), "endo pyramid shape")
    before = kernels.fast_nms_blur.launches
    got = kernels.fast_nms_blur_pyramid(levels, ex.ini_th, ex.min_th)
    expect(kernels.fast_nms_blur.launches == before + 1,
           "the endo pyramid took more than one launch")
    want = kernels.fast_nms_blur_pyramid_plain(levels, ex.ini_th, ex.min_th)
    torch.cuda.synchronize()
    for lvl, (g, w) in enumerate(zip(got, want)):
        expect_equal(g, w, f"endo pyramid level {lvl}")
    print(f"[proxy] endo pyramid {[tuple(v.shape) for v in levels]} in one "
          f"launch: scores equal, blur diff 0")


def run_proxy():
    """The real-texture proxies on the card. The four scenes rendered on
    the card against the CPU; the endoscopy pyramid through the kernel;
    then what a user runs: `make_proxy_dataset.main` renders PROXY_FRAMES
    frames of proxy_xyz on the card and writes them, and
    `run_proxy_eval.main` tracks them with `examples.mono_tum` and
    `examples.rgbd_tum`, holding RGB-D to n - 1 frames tracked at SE3 ATE
    < 0.08 m and mono to initialization by frame 12 at Sim3 ATE < 0.10 m.
    Returns the kernel launches of the two examples."""
    import contextlib
    import io
    import tempfile
    from orb_slam2_e_tpu_torch.examples import mono_tum, rgbd_tum
    from orb_slam2_e_tpu_torch.ops import kernels
    from orb_slam2_e_tpu_torch.tools import (make_proxy_dataset,
                                             run_proxy_eval)
    endo = check_proxy_render()
    check_endo_pyramid(endo)

    stage_ms = {}

    def instrumented(module, key):
        opened = module.open_system

        def open_system(*args, **kwargs):
            s, slam = opened(*args, **kwargs)
            stage_ms[key] = instrument(slam)
            return s, slam
        return open_system

    saved = {m: m.open_system for m in (mono_tum, rgbd_tum)}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            make_proxy_dataset.main([os.path.join(tmp, "proxy_xyz"),
                                     "--frames", str(PROXY_FRAMES),
                                     "--device", "cuda"])
        print(f"[proxy] make_proxy_dataset: {PROXY_FRAMES} frames of "
              f"proxy_xyz rendered on the card and written in "
              f"{time.perf_counter() - t0:.1f} s")
        mono_tum.open_system = instrumented(mono_tum, "mono")
        rgbd_tum.open_system = instrumented(rgbd_tum, "rgbd")
        kernels.fast_nms_blur.launches = 0
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                run_proxy_eval.main([
                    "--frames", str(PROXY_FRAMES), "--seqs", "xyz",
                    "--device", "cuda", "--data-dir", tmp,
                    "--out-dir", os.path.join(tmp, "eval")])
        except SystemExit as e:
            print(out.getvalue()[-3000:])
            raise AssertionError(f"run_proxy_eval: {e}") from None
        finally:
            for m, fn in saved.items():
                m.open_system = fn
        launches = kernels.fast_nms_blur.launches
        with open(os.path.join(tmp, "eval", "PROXY_RESULTS.json")) as f:
            res = json.load(f)
    for line in out.getvalue().splitlines():
        if line.startswith(("mono_xyz:", "rgbd_xyz:", "median", "mean")):
            print(f"[proxy] run_proxy_eval> {line}")
    for sensor, ref in PROXY_REF.items():
        r = res[f"{sensor}_xyz"]
        init = (f", initialized at frame {r['initialized_at_frame']} "
                f"(reference {ref['init']})" if sensor == "mono" else "")
        print(f"[proxy] {sensor}: {r['frames_tracked']} of {PROXY_FRAMES} "
              f"frames (reference {ref['tracked']}), "
              f"{r['alignment'].split()[0]} ATE {r['ate_rmse_frames_m']:.4f}"
              f" m (reference {ref['ate']}){init}; {r['frames_per_s']:.2f} "
              f"frames/s, {r['seconds']:.1f} s")
        for key, v in stage_ms[sensor].items():
            if v:
                print(f"[proxy] {sensor} stage {key}: median "
                      f"{statistics.median(v):.2f} ms over {len(v)} calls")
    print(f"[proxy] fast_nms_blur launches: {launches}")
    expect(res["rgbd_xyz"]["frames_tracked"] >= PROXY_FRAMES - 1
           and res["rgbd_xyz"]["ate_rmse_frames_m"] < ATE_MAX,
           f"proxy rgbd {res['rgbd_xyz']}")
    expect(res["mono_xyz"]["initialized_at_frame"] <= MONO_INIT_BY
           and res["mono_xyz"]["ate_rmse_frames_m"] < MONO_ATE_MAX,
           f"proxy mono {res['mono_xyz']}")
    expect(launches == 2 * PROXY_FRAMES, f"proxy launches {launches}")
    expect("jax" not in sys.modules and "cv2" not in sys.modules
           and "matplotlib" not in sys.modules, "jax, cv2 or matplotlib "
           "was imported")
    return launches


def main() -> int:
    t_start = time.perf_counter()
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
        + phase(run_loc, orbit, rgbd_state) + phase(run_deform)
        + phase(run_disk, *orbit))
    n_par, par_record = phase(run_parallel, orbit, rgbd_state)
    record["launches"] += n_par + phase(run_proxy)
    record.update(par_record)
    # one launch per extraction: 30 + 20 + 2 x 10 + 25 on the orbit, 96
    # around the ring, 6 + 12 + 30 in localization-only mode, 20 + 20 on
    # the deforming surface (none in the deformable phase's part A), 12 + 20
    # through the examples from disk; in the parallel phase one per step
    # for all 8 lanes (13), 8 bootstrap frames, 13 single-lane frames and
    # one profiled step of each kind; 40 + 40 proxy frames through the
    # examples
    expect(record["launches"] == 75 + 2 * STEREO_FRAMES + LOOP_FRAMES
           + LOC_ORBIT_FRAMES
           + LOC_MAPPED + LOC_FRAMES + DEFORM_MAPPED + DEFORM_FRAMES
           + DISK_FRAMES + DISK_MONO_FRAMES
           + PAR_LANES + 2 * (PAR_STEPS + 1) + 2 + 2 * PROXY_FRAMES,
           f"launch total {record['launches']}")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
