"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernel of the RGB-D main path from the sources
in this checkout, holds it against its plain torch twin on the card at every
pyramid-level shape of a 640x480 frame, then drives `SlamSystem` for
Sensor.RGBD on the card through 30 frames of a synthetic 640x480 scene with
the default SystemConfig (1000 features, 8 levels), and checks tracking,
trajectory error and that every frame went through the kernel.

Prints the card's name and power limit, a JSON line describing each kernel,
and as its last line {"ok": true, "device": {...}}. Exits non-zero, without
that line, when there is no CUDA device or any phase fails. Imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_FRAMES = 30
WIDTH, HEIGHT = 640, 480
TH_HIGH, TH_LOW = 20.0, 7.0
BLUR_TOL = 1e-3          # kernel vs plain blur, grey levels (scores: exact)
ATE_MAX = 0.08           # metres, SE3-aligned (the reference's e2e gate)
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


def make_frames():
    from orb_slam2_e_tpu_torch.utils.synthetic import (SyntheticScene,
                                                       orbit_trajectory)
    scene = SyntheticScene(n_points=600, seed=1, width=WIDTH, height=HEIGHT,
                           fx=500, fy=500, cx=WIDTH / 2, cy=HEIGHT / 2)
    poses, centers = orbit_trajectory(n_frames=60, radius=1.2, forward=0.03)
    frames = [(scene.render(R, t).astype(np.uint8), scene.depth_map(R, t))
              for R, t in poses[:N_FRAMES]]
    return frames, centers[:N_FRAMES]


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
            "replaces": REPLACES, "launches": None, "max_abs_err": max_err,
            "ms": min(ms, ms2), "plain_ms": plain_ms}


def run_slam(frames, centers):
    """The port's RGB-D main path on the card; returns the launch count."""
    from orb_slam2_e_tpu_torch.models.system import (SlamSystem,
                                                     SystemConfig, Sensor)
    from orb_slam2_e_tpu_torch.ops import kernels
    from orb_slam2_e_tpu_torch.ops.camera import Camera
    from orb_slam2_e_tpu_torch.utils.trajectory import ate_rmse

    cam = Camera.create(fx=500, fy=500, cx=320, cy=240, bf=40.0)
    slam = SlamSystem(cam, SystemConfig(pipeline=False, loop_closing=False),
                      Sensor.RGBD, device="cuda")
    stage_ms = {"extract": [], "track": [], "insert+map": []}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stage_ms[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    slam._make_frame = timed("extract", slam._make_frame)
    slam._track_step = timed("track", slam._track_step)
    slam._insert_keyframe = timed("insert+map", slam._insert_keyframe)

    kernels.fast_nms_blur.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tracked = 0
    for k, (img, depth) in enumerate(frames):
        out = slam.track_rgbd(img, depth, k / 30.0)
        tracked += out is not None
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.fast_nms_blur.launches

    ts, Rwc, twc = slam.get_trajectory()
    if not (np.isfinite(Rwc).all() and np.isfinite(twc).all()
            and twc.shape == (tracked, 3)):
        raise AssertionError("trajectory is not finite or has the wrong shape")
    ate = ate_rmse(twc, centers[-len(twc):], with_scale=False)
    n_pts = int(slam.map.lm_valid.sum())
    print(f"frames {len(frames)}: tracked {tracked}, keyframes "
          f"{slam.n_keyframes}, landmarks {n_pts}, SE3 ATE {ate:.4f} m")
    print(f"wall {wall:.2f} s = {len(frames) / wall:.2f} frames/s; stats "
          f"{slam.stats}")
    for name, v in stage_ms.items():
        if v:
            print(f"stage {name}: median {statistics.median(v):.2f} ms "
                  f"over {len(v)} calls")
    print(f"fast_nms_blur launches on the main path: {launches}")
    if tracked < len(frames) - 1:
        raise AssertionError(f"tracked {tracked} < {len(frames) - 1}")
    if not ate < ATE_MAX:
        raise AssertionError(f"ATE {ate} >= {ATE_MAX}")
    expected = slam.extractor.n_levels * len(frames)
    if launches != expected:
        raise AssertionError(f"{launches} kernel launches, expected "
                             f"{expected} (8 levels x frames)")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    print(card_line())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    import orb_slam2_e_tpu_torch  # noqa: F401  (precision settings)
    frames, centers = make_frames()
    record = check_kernel(frames[0][0])
    record["launches"] = run_slam(frames, centers)
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
