"""Generate a real-texture proxy dataset in EuRoC MAV format (twin of
tools/make_proxy_euroc.py), with RAW (distorted) stereo frames and the
LEFT./RIGHT. rectification blocks, so the stereo EuRoC example runs the
whole rectifier and the mono one the cam0 reader.

Layout:
    <out>/mav0/cam0/data/<ns>.png     raw distorted left frames
    <out>/mav0/cam0/data.csv          "#timestamp [ns],filename"
    <out>/mav0/cam1/data/<ns>.png     raw distorted right frames
    <out>/mav0/cam1/data.csv
    <out>/timestamps.txt              EuRoC-tools style ns list
    <out>/settings.yaml               rectified Camera.* + LEFT./RIGHT. blocks
    <out>/settings_mono.yaml          raw intrinsics + distortion
    <out>/groundtruth_tum.txt         ground truth in TUM format (for ATE)
    <out>/proxy.json                  the generator's arguments

Distortion: radtan (k1, k2) applied to the rendered rays: each raw pixel's
ray is the inverse-distorted normalized coordinate, so rectification with
the written maps recovers an exact pinhole.

Usage:
    python3 -m orb_slam2_e_tpu_torch.tools.make_proxy_euroc <out_dir>
        [--frames 120] [--seed 2] [--device cuda] [--textures ...]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..utils.imageio import write_png
from .make_proxy_dataset import (add_common_args, gt_line, quat32,
                                 trajectory, write_record)
from .proxy_render import build_room, render

W, H = 512, 384
FX = FY = 320.0          # raw intrinsics
CX, CY = 256.0, 192.0
K1, K2 = -0.22, 0.05     # EuRoC-like radial distortion
BASELINE = 0.11          # m
# rectified projection: same focal, same principal point (proxy cameras are
# already row-aligned -> R = I and rectification is pure undistortion)
BF = FX * BASELINE
FPS = 20.0


def _inverse_distort_dirs():
    """(H, W, 3) ray directions for the RAW image: invert the radial
    distortion per pixel (10 fixed-point steps)."""
    us, vs = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    xd = (us - CX) / FX
    yd = (vs - CY) / FY
    x, y = xd.copy(), yd.copy()
    for _ in range(10):
        r2 = x * x + y * y
        rad = 1.0 + r2 * (K1 + r2 * K2)
        x = xd / rad
        y = yd / rad
    return np.stack([x, y, np.ones_like(x)], -1)


def _mat_yaml(name, arr, rows, cols):
    flat = ", ".join(f"{v:.10f}" for v in np.asarray(arr).ravel())
    return (f"{name}: !!opencv-matrix\n   rows: {rows}\n   cols: {cols}\n"
            f"   dt: d\n   data: [{flat}]\n")


def settings_yaml():
    K = [FX, 0, CX, 0, FY, CY, 0, 0, 1]
    D = [K1, K2, 0.0, 0.0, 0.0]
    R = np.eye(3)
    P_l = [FX, 0, CX, 0, 0, FY, CY, 0, 0, 0, 1, 0]
    P_r = [FX, 0, CX, -BF, 0, FY, CY, 0, 0, 0, 1, 0]
    s = f"""%YAML:1.0
Camera.fx: {FX}
Camera.fy: {FY}
Camera.cx: {CX}
Camera.cy: {CY}
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: {W}
Camera.height: {H}
Camera.fps: {FPS}
Camera.RGB: 1
Camera.bf: {BF}
ThDepth: 40.0
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
LEFT.width: {W}
LEFT.height: {H}
RIGHT.width: {W}
RIGHT.height: {H}
"""
    s += _mat_yaml("LEFT.K", K, 3, 3)
    s += _mat_yaml("LEFT.D", D, 1, 5)
    s += _mat_yaml("LEFT.R", R, 3, 3)
    s += _mat_yaml("LEFT.P", P_l, 3, 4)
    s += _mat_yaml("RIGHT.K", K, 3, 3)
    s += _mat_yaml("RIGHT.D", D, 1, 5)
    s += _mat_yaml("RIGHT.R", R, 3, 3)
    s += _mat_yaml("RIGHT.P", P_r, 3, 4)
    return s


def settings_mono_yaml():
    """Monocular settings: RAW intrinsics + distortion coefficients (the
    reference ships Monocular/EuRoC.yaml with k1/k2 set and Stereo/EuRoC.yaml
    with a rectified pinhole; keypoint undistortion handles the raw frames
    on the mono path)."""
    return f"""%YAML:1.0
Camera.fx: {FX}
Camera.fy: {FY}
Camera.cx: {CX}
Camera.cy: {CY}
Camera.k1: {K1}
Camera.k2: {K2}
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: {W}
Camera.height: {H}
Camera.fps: {FPS}
Camera.RGB: 1
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def render_pair(planes, R, t, dirs, device):
    """(left, right) raw distorted frames along the rays `dirs`."""
    img_l, _ = render(planes, R, t, dirs=dirs, device=device)
    img_r, _ = render(planes, R, t - np.array([BASELINE, 0, 0]), dirs=dirs,
                      device=device)
    return img_l, img_r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    add_common_args(ap, seed=2, frames=120)
    args = ap.parse_args(argv)

    out = Path(args.out)
    cam0 = out / "mav0" / "cam0" / "data"
    cam1 = out / "mav0" / "cam1" / "data"
    cam0.mkdir(parents=True, exist_ok=True)
    cam1.mkdir(parents=True, exist_ok=True)

    planes = build_room(seed=args.seed, which=args.textures)
    poses, centers = trajectory("xyz", args.frames)
    dirs = _inverse_distort_dirs()

    csv0, csv1, ts_lines, gt = (["#timestamp [ns],filename"],
                                ["#timestamp [ns],filename"], [], [])
    for k, (R, t) in enumerate(poses):
        ns = int(round(k / FPS * 1e9))
        img_l, img_r = render_pair(planes, R, t, dirs, args.device)
        name = f"{ns}.png"
        write_png(cam0 / name, img_l)
        write_png(cam1 / name, img_r)
        csv0.append(f"{ns},{name}")
        csv1.append(f"{ns},{name}")
        ts_lines.append(str(ns))
        gt.append(gt_line(k / FPS, centers[k], quat32(R.T)))
        if k % 40 == 0:
            print(f"  frame {k}/{args.frames}")

    (out / "mav0" / "cam0" / "data.csv").write_text("\n".join(csv0) + "\n")
    (out / "mav0" / "cam1" / "data.csv").write_text("\n".join(csv1) + "\n")
    (out / "timestamps.txt").write_text("\n".join(ts_lines) + "\n")
    (out / "groundtruth_tum.txt").write_text("\n".join(gt) + "\n")
    (out / "settings.yaml").write_text(settings_yaml())
    (out / "settings_mono.yaml").write_text(settings_mono_yaml())
    write_record(out, args, generator="make_proxy_euroc")
    print(f"wrote {args.frames} raw stereo frames to {out}")


if __name__ == "__main__":
    main()
