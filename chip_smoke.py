"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernel from the sources in this checkout and
holds it against its plain torch twin on the card at every pyramid-level
shape of a 640x480 frame. Then drives `SlamSystem` on the card through four
phases on a synthetic 640x480 scene (camera fx=fy=500, 8 levels, 1000
features), each through the entry point a user calls:

1. RGB-D, default SystemConfig, 30 frames;
2. monocular, the benchmark's configuration (bench.py), 30 frames;
3. stereo, default SystemConfig, 20 frames;
4. RGB-D with frame 20 blanked, 30 frames: one LOST frame, relocalized.

Each phase checks tracking, trajectory error, its own gates and that every
extraction went through the kernel (the launch count is zeroed before the
phase and read after it). Prints per-stage median ms, the card's name and
power limit, a JSON line describing the kernel, and as its last line
{"ok": true, "device": {...}}. Exits non-zero, without that line, when
there is no CUDA device or any phase fails. Imports no JAX.
"""

from __future__ import annotations

import json
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
BLUR_TOL = 1e-3          # kernel vs plain blur, grey levels (scores: exact)
ATE_MAX = 0.08           # metres, SE3-aligned (the reference's e2e gate)
MONO_ATE_MAX = 0.10      # Sim3-aligned (the reference's mono e2e gate)
MONO_INIT_BY = 12        # mono must initialize by this frame
BLANK = 20               # the relocalization phase's blanked frame
KERNEL_SOURCE = "orb_slam2_e_tpu_torch/csrc/fast_nms_blur.cu"
REPLACES = "orb_slam2_e_tpu/ops/pallas_kernels.py:148"


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


def check_kernel(image0: np.ndarray):
    """Kernel vs plain twin on the card at every level of the frame's
    pyramid; times both at level 0. Returns the kernel's JSON record."""
    from orb_slam2_e_tpu_torch.ops import kernels, orb
    t0 = time.perf_counter()
    kernels.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {' '.join(kernels.NVCC_FLAGS)})")
    ex = orb.OrbExtractor()
    img0 = torch.as_tensor(image0, device="cuda").to(torch.float32)
    max_err = 0.0
    for lvl, s in enumerate(ex.scales):
        h, w = int(round(HEIGHT / s)), int(round(WIDTH / s))
        img = img0 if lvl == 0 else orb.resize_bilinear(img0, h, w)
        img = img.contiguous()
        sk, bk = kernels.fast_nms_blur(img, TH_HIGH, TH_LOW)
        sp, bp = kernels.fast_nms_blur_plain(img, TH_HIGH, TH_LOW)
        torch.cuda.synchronize()
        score_eq = torch.equal(sk, sp)
        blur_err = (bk - bp).abs().max().item()
        max_err = max(max_err, blur_err)
        print(f"level {lvl} {h}x{w}: score exact={score_eq} "
              f"({int((sk > 0).sum())} corners) blur max|diff|={blur_err:.3g}")
        if not score_eq or blur_err > BLUR_TOL:
            raise AssertionError(f"kernel disagrees with plain at level {lvl}")
    ms = time_ms(lambda: kernels.fast_nms_blur(img0, TH_HIGH, TH_LOW))
    plain_ms = time_ms(lambda: kernels.fast_nms_blur_plain(img0, TH_HIGH,
                                                           TH_LOW))
    ms2 = time_ms(lambda: kernels.fast_nms_blur(img0, TH_HIGH, TH_LOW))
    print(f"level 0 {HEIGHT}x{WIDTH}: kernel {ms:.4f} / {ms2:.4f} ms, "
          f"plain torch {plain_ms:.4f} ms")

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
    return {"name": "fast_nms_blur", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES, "launches": 0, "max_abs_err": max_err,
            "ms": min(ms, ms2), "plain_ms": plain_ms}


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
    expect(r["launches"] == slam.extractor.n_levels * n_frames,
           f"rgbd launches {r['launches']}")
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
    expect(r["launches"] == cfg.n_levels * n_frames,
           f"mono launches {r['launches']}")
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
    expect(r["launches"] == 2 * slam.extractor.n_levels * n_frames,
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
    expect(r["launches"] == slam.extractor.n_levels * n_frames,
           f"reloc launches {r['launches']}")
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
