"""Generate a real-texture proxy dataset in TUM RGB-D format (twin of
tools/make_proxy_dataset.py).

Frames are rendered by the exact textured-plane raycaster of
`proxy_render` over real imagery (a photograph, an MRI slice, two
measured elevation rasters; `sample_data/README`), along a handheld-like
trajectory with exact ground truth and exact depth maps. The sequences
are no substitute for TUM's (no sensor noise, rolling shutter, lighting
change or motion blur), but they drive FAST, the descriptors and the
vocabulary with natural image statistics through the example programs.

Layout written (TUM RGB-D convention):
    <out>/rgb/<t>.png          8-bit grey frames
    <out>/depth/<t>.png        16-bit depth, 5000 units = 1 m
    <out>/rgb.txt, depth.txt, associations.txt, groundtruth.txt
    <out>/settings.yaml        cv::FileStorage-style settings (TUM1-like)
    <out>/proxy.json           the generator's arguments, textures included

Usage:
    python3 -m orb_slam2_e_tpu_torch.tools.make_proxy_dataset <out_dir>
        [--seq xyz|desk] [--frames N] [--seed 0] [--device cuda]
        [--textures hopper,mri,topo,dem]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..ops import lie
from ..utils.imageio import write_png
from .proxy_render import (CX, CY, FX, FY, H, TEXTURES, W, build_room,
                           render)

FPS = 30.0
DEPTH_FACTOR = 5000.0


def so3_exp32(rot) -> np.ndarray:
    """Rotation of the (3,) vector `rot`, computed in float32 on the CPU as
    the reference computes it (lie.so3_exp of a float32 array), returned as
    float64."""
    w = torch.as_tensor(np.asarray(rot), dtype=torch.float32)
    return lie.so3_exp(w).numpy().astype(np.float64)


def quat32(Rwc: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of a rotation, in float32 on the CPU (lie.quat_from_mat
    of a float32 array), as the reference's ground truth writes it."""
    R = torch.as_tensor(np.asarray(Rwc)[None], dtype=torch.float32)
    return lie.quat_from_mat(R)[0].numpy()


def gt_line(ts: float, c, q) -> str:
    """A TUM ground-truth line: `t tx ty tz qx qy qz qw`."""
    return (f"{ts:.6f} {c[0]:.7f} {c[1]:.7f} {c[2]:.7f} "
            f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}")


def trajectory(kind: str, n: int):
    """Returns (R_cw list, t list) world-to-camera + camera centers."""
    poses, centers = [], []
    for k in range(n):
        s = k / FPS
        if kind == "xyz":
            # fr1_xyz style: translation-dominant, per-axis sinusoids
            c = np.array([0.45 * np.sin(0.9 * s),
                          0.25 * np.sin(1.4 * s + 1.0),
                          0.35 * np.sin(0.6 * s + 2.0)])
            rot = np.array([0.04 * np.sin(0.8 * s + 0.3),
                            0.08 * np.sin(0.5 * s),
                            0.03 * np.sin(1.1 * s)])
        else:
            # fr1_desk style: sweeping yaw + translation arc
            c = np.array([1.1 * np.sin(0.35 * s),
                          0.15 * np.sin(1.1 * s),
                          0.5 - 0.5 * np.cos(0.35 * s)])
            rot = np.array([0.05 * np.sin(0.7 * s),
                            0.45 * np.sin(0.35 * s + 0.5),
                            0.04 * np.sin(0.9 * s)])
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
Camera.k3: 0.0
Camera.width: {W}
Camera.height: {H}
Camera.fps: {FPS}
Camera.RGB: 1
Camera.bf: 40.0
ThDepth: 40.0
DepthMapFactor: {DEPTH_FACTOR}
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def parse_textures(text: str) -> tuple:
    """`hopper,mri` -> ("hopper", "mri"), checked against TEXTURES."""
    names = tuple(s for s in text.split(",") if s)
    if not names or set(names) - set(TEXTURES):
        raise argparse.ArgumentTypeError(
            f"textures: a comma-separated subset of {','.join(TEXTURES)}")
    return names


def add_common_args(ap, seed: int, frames: int):
    """The options every generator takes."""
    ap.add_argument("out")
    ap.add_argument("--frames", type=int, default=frames)
    ap.add_argument("--seed", type=int, default=seed)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the renderer (default: cuda)")
    ap.add_argument("--textures", type=parse_textures, default=TEXTURES,
                    help="source images to tile the surfaces from "
                         "(default: all four)")


def write_record(out: Path, args, **extra):
    """proxy.json: what the sequence was generated with."""
    rec = {"generator": __package__ + "." + extra.pop("generator"),
           "frames": args.frames, "seed": args.seed,
           "textures": list(args.textures), "device": str(args.device),
           **extra}
    (out / "proxy.json").write_text(json.dumps(rec, indent=2) + "\n")


def depth_png(depth: np.ndarray) -> np.ndarray:
    return np.clip(depth * DEPTH_FACTOR, 0, 65535).astype(np.uint16)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    add_common_args(ap, seed=0, frames=400)
    ap.add_argument("--seq", default="xyz", choices=["xyz", "desk"])
    args = ap.parse_args(argv)

    out = Path(args.out)
    (out / "rgb").mkdir(parents=True, exist_ok=True)
    (out / "depth").mkdir(parents=True, exist_ok=True)

    planes = build_room(seed=args.seed, which=args.textures)
    poses, centers = trajectory(args.seq, args.frames)

    rgb_lines, depth_lines, assoc, gt = [], [], [], []
    for k, (R, t) in enumerate(poses):
        ts = k / FPS
        img, depth = render(planes, R, t, device=args.device)
        name = f"{ts:.6f}.png"
        write_png(out / "rgb" / name, img)
        write_png(out / "depth" / name, depth_png(depth))
        rgb_lines.append(f"{ts:.6f} rgb/{name}")
        depth_lines.append(f"{ts:.6f} depth/{name}")
        assoc.append(f"{ts:.6f} rgb/{name} {ts:.6f} depth/{name}")
        gt.append(gt_line(ts, centers[k], quat32(R.T)))
        if k % 50 == 0:
            print(f"  frame {k}/{args.frames}")

    hdr = "# real-texture proxy sequence (tools/make_proxy_dataset.py)\n"
    (out / "rgb.txt").write_text(hdr + "\n".join(rgb_lines) + "\n")
    (out / "depth.txt").write_text(hdr + "\n".join(depth_lines) + "\n")
    (out / "associations.txt").write_text("\n".join(assoc) + "\n")
    (out / "groundtruth.txt").write_text(hdr + "\n".join(gt) + "\n")
    (out / "settings.yaml").write_text(SETTINGS_YAML)
    write_record(out, args, generator="make_proxy_dataset", seq=args.seq)
    print(f"wrote {args.frames} frames to {out}")


if __name__ == "__main__":
    main()
