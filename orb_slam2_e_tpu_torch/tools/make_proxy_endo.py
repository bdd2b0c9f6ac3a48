"""Deformable-surface proxy sequence, the stand-in for the endoscopy
sequences the deformable relocalization is evaluated on (twin of
tools/make_proxy_endo.py).

  * a smooth heightmap surface tessellated into 13 x 9 textured quads,
    each textured from the real imagery of `proxy_render`;
  * phase "map": the surface at rest, the camera sweeping, to build a map;
  * phase "reloc": the surface breathing (a time-varying smooth
    deformation of the control grid, amplitude --amp in surface units)
    along a sweep that starts elsewhere, for the relocalization KPI runs
    in localization-only mode against the phase-"map" map.

Writes TUM-format rgb/ + rgb.txt + groundtruth.txt + settings.yaml with the
RelocParam keys of the KPI protocol preset, and proxy.json.

Usage:
  python3 -m orb_slam2_e_tpu_torch.tools.make_proxy_endo <out_dir>
      --phase map|reloc [--frames 240] [--amp 0.12] [--seed 5]
      [--device cuda] [--textures ...]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..utils.imageio import write_png
from .make_proxy_dataset import add_common_args, write_record
from .proxy_render import (TEXTURES, Plane, load_real_textures,
                           make_plane_texture, render)

W, H = 480, 360
FX = FY = 420.0
CX, CY = 240.0, 180.0
FPS = 30.0
NEAR, FAR = 0.05, 30.0

GRID_X, GRID_Y = 14, 10        # control grid (quads = (GX-1)*(GY-1))
EXTENT_X, EXTENT_Y = 5.4, 4.0  # surface span (units ~ cm-scale scene)
BASE_Z = 3.2


def _surface_points(amp: float, t: float, seed: int):
    """Control-grid 3D points: static relief + breathing."""
    rng = np.random.RandomState(seed)
    xs = np.linspace(-EXTENT_X / 2, EXTENT_X / 2, GRID_X)
    ys = np.linspace(-EXTENT_Y / 2, EXTENT_Y / 2, GRID_Y)
    gx, gy = np.meshgrid(xs, ys)                       # (GY, GX)
    # static relief: smooth random bumps (fixed per sequence)
    relief = np.zeros_like(gx)
    for _ in range(6):
        cx_ = rng.uniform(-1.5, 1.5)
        cy_ = rng.uniform(-1.0, 1.0)
        s = rng.uniform(0.5, 1.2)
        a = rng.uniform(-0.25, 0.35)
        relief += a * np.exp(-(((gx - cx_) ** 2 + (gy - cy_) ** 2)
                               / (2 * s * s)))
    # breathing: two smooth traveling modes (amplitude `amp`)
    breathe = amp * (np.sin(2 * np.pi * 0.45 * t + gx * 1.2)
                     * np.exp(-(gx ** 2 + gy ** 2) / 3.0)
                     + 0.6 * np.sin(2 * np.pi * 0.27 * t + gy * 1.7))
    gz = BASE_Z + relief + breathe
    return np.stack([gx, gy, gz], -1)                  # (GY, GX, 3)


def _make_patches(pts, textures):
    """Quad patches between grid points; each quad is a Plane whose ex/ey
    follow the deformed grid (texture rides the surface)."""
    planes = []
    k = 0
    for j in range(GRID_Y - 1):
        for i in range(GRID_X - 1):
            p00 = pts[j, i]
            p10 = pts[j, i + 1]
            p01 = pts[j + 1, i]
            planes.append(Plane(p00, p10 - p00, p01 - p00, textures[k]))
            k += 1
    return planes


def _patch_textures(seed: int, which=TEXTURES):
    rng = np.random.RandomState(seed)
    texs = load_real_textures(which)
    return [make_plane_texture(rng, texs, (96, 96))
            for _ in range((GRID_X - 1) * (GRID_Y - 1))]


def _trajectory(n: int, phase: str):
    from scipy.spatial.transform import Rotation
    poses, centers = [], []
    for k in range(n):
        t = k / FPS
        # sweeping arc over the surface, slight pitch to keep it in view;
        # the reloc phase starts mid-arc (another offset), so it
        # relocalizes from novel viewpoints
        ph = 0.0 if phase == "map" else 0.9
        c = np.array([1.1 * np.sin(0.30 * t + ph),
                      0.6 * np.sin(0.21 * t + 0.7 + ph),
                      0.45 * np.sin(0.17 * t + ph) - 0.1])
        rot = np.array([0.10 * np.sin(0.23 * t + ph),
                        0.12 * np.sin(0.31 * t + 0.4 + ph),
                        0.05 * np.sin(0.40 * t)])
        Rwc = Rotation.from_rotvec(rot).as_matrix()
        R = Rwc.T
        tt = -R @ c
        poses.append((R, tt))
        centers.append(c)
    return poses, np.stack(centers)


def render_frame(textures, R, t, amp, ts, seed, device):
    """One grey frame of the surface at time `ts`."""
    planes = _make_patches(_surface_points(amp, ts, seed), textures)
    img, _ = render(planes, R, t, near=NEAR, far=FAR, size=(W, H),
                    intrinsics=(FX, FY, CX, CY), device=device)
    return img


SETTINGS = f"""%YAML:1.0
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
ORBextractor.nFeatures: 1200
ORBextractor.scaleFactor: 1.1
ORBextractor.nLevels: 6
ORBextractor.iniThFAST: 24
ORBextractor.minThFAST: 7
RelocParam.bTestAllFrames: 1
RelocParam.nPrecisionFrames: 2
RelocParam.nElType: 1
"""
# ORB params mirror the reference's endoscopy tuning
# (roslaunch/sHamlyn01.yaml:71-84: 1200 feats, scale 1.1, 6 levels,
# iniThFAST 24)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    add_common_args(ap, seed=5, frames=240)
    ap.add_argument("--phase", choices=["map", "reloc"], required=True)
    ap.add_argument("--amp", type=float, default=0.12,
                    help="breathing amplitude (reloc phase)")
    args = ap.parse_args(argv)

    from scipy.spatial.transform import Rotation

    out = Path(args.out)
    (out / "rgb").mkdir(parents=True, exist_ok=True)
    textures = _patch_textures(args.seed, args.textures)
    poses, centers = _trajectory(args.frames, args.phase)
    amp = 0.0 if args.phase == "map" else args.amp

    rgb_lines, gt = [], []
    for k, (R, t) in enumerate(poses):
        ts = k / FPS
        img = render_frame(textures, R, t, amp, ts, args.seed, args.device)
        name = f"{ts:.6f}.png"
        write_png(out / "rgb" / name, img)
        rgb_lines.append(f"{ts:.6f} rgb/{name}")
        qx, qy, qz, qw = Rotation.from_matrix(R.T).as_quat()
        c = centers[k]
        gt.append(f"{ts:.6f} {c[0]:.7f} {c[1]:.7f} {c[2]:.7f} "
                  f"{qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}")
        if k % 40 == 0:
            print(f"  frame {k}/{args.frames} (amp={amp})")

    hdr = "# deformable real-texture proxy (tools/make_proxy_endo.py)\n"
    (out / "rgb.txt").write_text(hdr + "\n".join(rgb_lines) + "\n")
    (out / "groundtruth.txt").write_text(hdr + "\n".join(gt) + "\n")
    (out / "settings.yaml").write_text(SETTINGS)
    write_record(out, args, generator="make_proxy_endo", phase=args.phase,
                 amp=amp)
    print(f"wrote {args.frames} frames ({args.phase}) to {out}")


if __name__ == "__main__":
    main()
