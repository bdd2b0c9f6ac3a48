"""Generate a real-texture proxy dataset in KITTI odometry format (twin of
tools/make_proxy_kitti.py): the proxy room of `proxy_render`, a stereo
pair at a 0.12 m baseline along a forward arc, in the layout the KITTI
examples read:

    <out>/image_0/000000.png ...     left grey frames
    <out>/image_1/000000.png ...     right grey frames
    <out>/times.txt                  one timestamp per line
    <out>/settings.yaml              KITTI-style settings
    <out>/groundtruth_tum.txt        ground truth in TUM format (for ATE)
    <out>/proxy.json                 the generator's arguments

Usage:
    python3 -m orb_slam2_e_tpu_torch.tools.make_proxy_kitti <out_dir>
        [--frames 120] [--seed 1] [--device cuda] [--textures ...]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..utils.imageio import write_png
from .make_proxy_dataset import (add_common_args, gt_line, quat32,
                                 so3_exp32, write_record)
from .proxy_render import build_room, render

# proxy-KITTI camera: wide aspect like KITTI, sized for fast smoke tests
W, H = 640, 256
FX = FY = 350.0
CX, CY = 320.0, 128.0
BASELINE = 0.12          # m -> bf = 42.0
BF = FX * BASELINE
FPS = 10.0               # KITTI camera rate


def forward_trajectory(n: int):
    """Forward-dominant arc inside the proxy room (KITTI style: forward
    motion + gentle yaw), world-to-camera poses + centers."""
    poses, centers = [], []
    for k in range(n):
        s = k / FPS
        c = np.array([0.35 * np.sin(0.25 * s),
                      0.05 * np.sin(0.9 * s),
                      min(0.28 * s, 3.2)])
        rot = np.array([0.02 * np.sin(0.7 * s),
                        0.10 * np.sin(0.25 * s + 0.4),
                        0.02 * np.sin(0.5 * s)])
        R = so3_exp32(rot).T
        t = -R @ c
        poses.append((R, t))
        centers.append(c)
    return poses, np.stack(centers)


SETTINGS_YAML = f"""%YAML:1.0
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
"""


def render_pair(planes, R, t, device):
    """(left, right) grey frames; the right camera's optical centre is
    shifted by the baseline along the camera x-axis (x_r = R X + t - [b, 0,
    0])."""
    size, intr = (W, H), (FX, FY, CX, CY)
    img_l, _ = render(planes, R, t, size=size, intrinsics=intr,
                      device=device)
    img_r, _ = render(planes, R, t - np.array([BASELINE, 0, 0]), size=size,
                      intrinsics=intr, device=device)
    return img_l, img_r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    add_common_args(ap, seed=1, frames=120)
    args = ap.parse_args(argv)

    out = Path(args.out)
    (out / "image_0").mkdir(parents=True, exist_ok=True)
    (out / "image_1").mkdir(parents=True, exist_ok=True)

    planes = build_room(seed=args.seed, which=args.textures)
    poses, centers = forward_trajectory(args.frames)

    times, gt = [], []
    for k, (R, t) in enumerate(poses):
        ts = k / FPS
        img_l, img_r = render_pair(planes, R, t, args.device)
        write_png(out / "image_0" / f"{k:06d}.png", img_l)
        write_png(out / "image_1" / f"{k:06d}.png", img_r)
        times.append(f"{ts:.6e}")
        gt.append(gt_line(ts, centers[k], quat32(R.T)))
        if k % 40 == 0:
            print(f"  frame {k}/{args.frames}")

    (out / "times.txt").write_text("\n".join(times) + "\n")
    (out / "groundtruth_tum.txt").write_text("\n".join(gt) + "\n")
    (out / "settings.yaml").write_text(SETTINGS_YAML)
    write_record(out, args, generator="make_proxy_kitti")
    print(f"wrote {args.frames} stereo frames to {out}")


if __name__ == "__main__":
    main()
