"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernel (and, beside it, the earlier one-level
kernel as a timing baseline) from the sources in this checkout. Holds the kernel
against its plain torch twin on the card: the whole 8-level pyramid of a
640x480 frame in one launch, and two odd shapes through the one-level
entry. Times it by replaying a CUDA graph of back-to-back launches, at level
0 and for the pyramid, beside the baseline, the wrapper's call rate, the
plain version and the card's bound for the same work. Then drives
`SlamSystem` on the card through four phases on a synthetic 640x480 scene
(camera fx=fy=500, 8 levels, 1000 features), each through the entry point a
user calls:

1. RGB-D, default SystemConfig, 30 frames;
2. monocular, the benchmark's configuration (bench.py), 30 frames;
3. stereo, default SystemConfig, 20 frames;
4. RGB-D with frame 20 blanked, 30 frames: one LOST frame, relocalized.

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


def drive(name, slam, inputs, centers, with_scale):
    """One phase: `inputs[k]` fed to the sensor's entry point for every
    frame, timed per stage between synchronizations. Returns a summary."""
    from orb_slam2_e_tpu_torch.models.system import Sensor
    from orb_slam2_e_tpu_torch.ops import kernels
    from orb_slam2_e_tpu_torch.utils.trajectory import ate_rmse
    stages = {"extract": "_make_frame_inputs", "track": "_track_step",
              "insert+map": "_insert_keyframe", "relocalize": "_relocalize",
              "init": "_initialize"}
    stage_ms = {k: [] for k in stages}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stage_ms[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    for key, attr in stages.items():
        setattr(slam, attr, timed(key, getattr(slam, attr)))
    entry = {Sensor.RGBD: slam.track_rgbd, Sensor.MONOCULAR:
             slam.track_monocular, Sensor.STEREO: slam.track_stereo}[
        slam.sensor]

    kernels.fast_nms_blur.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = []
    for k, args in enumerate(inputs):
        pose = entry(*args, k / 30.0)
        est.append(None if pose is None else
                   (-pose[0].T @ pose[1]).double().cpu().numpy())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.fast_nms_blur.launches

    tracked = [k for k, c in enumerate(est) if c is not None]
    _, Rwc, twc = slam.get_trajectory()
    if not (np.isfinite(Rwc).all() and np.isfinite(twc).all()
            and twc.shape == (len(tracked), 3)):
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
    print(f"[{name}] fast_nms_blur launches: {launches}")
    return {"tracked": tracked, "ate": ate, "launches": launches}


def expect(cond, what):
    if not cond:
        raise AssertionError(what)


def run_rgbd(scene, poses, centers, n_frames=30):
    from orb_slam2_e_tpu_torch.models.system import (SlamSystem,
                                                     SystemConfig, Sensor)
    from orb_slam2_e_tpu_torch.ops.camera import Camera
    cam = Camera.create(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2, bf=BF)
    slam = SlamSystem(cam, SystemConfig(pipeline=False, loop_closing=False),
                      Sensor.RGBD, device="cuda")
    inputs = [(grey(scene, R, t), scene.depth_map(R, t))
              for R, t in poses[:n_frames]]
    r = drive("rgbd", slam, inputs, centers[:n_frames], with_scale=False)
    expect(len(r["tracked"]) >= n_frames - 1, f"rgbd tracked {r}")
    expect(r["ate"] < ATE_MAX, f"rgbd ATE {r['ate']}")
    expect(r["launches"] == n_frames, f"rgbd launches {r['launches']}")
    return r["launches"]


def run_mono(scene, poses, centers, n_frames=30):
    """bench.py's monocular configuration."""
    from orb_slam2_e_tpu_torch.models.system import (SlamSystem,
                                                     SystemConfig, Sensor)
    from orb_slam2_e_tpu_torch.ops.camera import Camera
    cam = Camera.create(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2,
                        width=WIDTH, height=HEIGHT)
    cfg = SystemConfig(max_keyframes=64, max_points=16384, n_features=1000,
                       n_levels=8, max_frames_between_kf=6,
                       min_init_matches=80, pipeline=False,
                       loop_closing=False)
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


def run_stereo(scene, poses, centers, n_frames=20):
    from orb_slam2_e_tpu_torch.models.system import (SlamSystem,
                                                     SystemConfig, Sensor)
    from orb_slam2_e_tpu_torch.ops.camera import Camera
    cam = Camera.create(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2, bf=BF,
                        width=WIDTH, height=HEIGHT)
    slam = SlamSystem(cam, SystemConfig(pipeline=False, loop_closing=False),
                      Sensor.STEREO, device="cuda")
    # the right camera sits one baseline along the camera x axis
    shift = np.array([-BF / FX, 0.0, 0.0], np.float32)
    inputs = [(grey(scene, R, t), grey(scene, R, t + shift))
              for R, t in poses[:n_frames]]
    r = drive("stereo", slam, inputs, centers[:n_frames], with_scale=False)
    expect(len(r["tracked"]) >= n_frames - 1, f"stereo tracked {r}")
    expect(r["ate"] < ATE_MAX, f"stereo ATE {r['ate']}")
    expect(r["launches"] == 2 * n_frames,
           f"stereo launches {r['launches']}")
    return r["launches"]


def run_reloc(scene, poses, centers, n_frames=30):
    """RGB-D with one blank frame: tracking is lost there and the next
    frame is relocalized (BoW candidates, PnP RANSAC, the rigid ladder)."""
    from orb_slam2_e_tpu_torch.models.system import (SlamSystem,
                                                     SystemConfig, Sensor)
    from orb_slam2_e_tpu_torch.ops.camera import Camera
    cam = Camera.create(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2, bf=BF)
    slam = SlamSystem(cam, SystemConfig(pipeline=False, loop_closing=False),
                      Sensor.RGBD, device="cuda")
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
    for phase in (run_rgbd, run_mono, run_stereo, run_reloc):
        t0 = time.perf_counter()
        record["launches"] += phase(scene, poses, centers)
        print(f"{phase.__name__}: passed in {time.perf_counter() - t0:.1f} s")
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
