"""The real-texture proxy scenes: source imagery, plane textures, the exact
textured-plane raycaster, and the proxy room (twin of
tools/make_proxy_dataset.py:59-221).

The source imagery ships beside this module in `sample_data/` (see its
README): a photograph, an MRI slice and two measured elevation rasters,
the files the reference reads from matplotlib's sample data. Every plane
texture is tiled from random crops of them; `render` intersects each
pixel's ray with every plane, keeps the nearest hit and samples its
texture bilinearly. It runs in torch on the device it is given, in float64
as the reference's numpy does, and returns numpy arrays.

Two functions of OpenCV that the reference calls are reproduced in numpy /
torch, bit for bit on the inputs the generators give them:
`cv2.resize(..., INTER_AREA)` (`resize_area`) and
`cv2.remap(..., INTER_LINEAR)` on float32 maps (`_bilinear`, three fused
multiply-adds, emulated in float64 and rounded once to float32).

The reference computes `ndarray.ptp()`, which NumPy 2 removed, inside a
`try/except`: under NumPy 2 its room is tiled from the photograph alone.
`load_real_textures(("hopper",))` reproduces that; the default loads all
four. That uncovers a second fault the first one hid: the bathymetry
raster is 91 x 120, smaller than a 160-pixel tile, and the reference's
crop draw `randint(160, min(320, 91))` raises on it. Here a source image
smaller than a tile plus one pixel is first enlarged by the least integer
factor that makes it larger (bilinear, corners aligned: 91 x 120 becomes
182 x 240); the other three are as the reference reads them.
"""

from __future__ import annotations

import gzip
import math
from pathlib import Path

import numpy as np
import torch

from ..utils.imageio import read_gray8

W, H = 640, 480
FX, FY, CX, CY = 517.3, 516.5, 318.6, 255.3   # TUM1 intrinsics (undistorted)

SAMPLE_DATA = Path(__file__).resolve().parent / "sample_data"
TEXTURES = ("hopper", "mri", "topo", "dem")
PLANE_CHUNK = 16      # planes intersected per batch of tensor operations
TILE = 160            # texture tile side, px


# ---------------------------------------------------------------------------
# Source imagery
# ---------------------------------------------------------------------------

def _enlarge_to_tile(x: np.ndarray) -> np.ndarray:
    """`x` itself if both sides exceed TILE, else `x` enlarged by the least
    integer factor that makes them do (bilinear, corners aligned)."""
    if min(x.shape) > TILE:
        return x
    f = TILE // min(x.shape) + 1
    h, w = x.shape
    ys = np.linspace(0.0, h - 1, f * h)
    xs = np.linspace(0.0, w - 1, f * w)
    rows = np.stack([np.interp(xs, np.arange(w), r) for r in
                     x.astype(np.float64)])
    out = np.stack([np.interp(ys, np.arange(h), c) for c in rows.T], 1)
    return out.astype(np.float32)


def _hillshade(z: np.ndarray) -> np.ndarray:
    gy, gx = np.gradient(z)
    shade = gx * 0.7 + gy * 0.7
    return 255.0 * (shade - shade.min()) / max(float(np.ptp(shade)), 1.0)


def load_real_textures(which=TEXTURES) -> list[np.ndarray]:
    """The source images as float32 grey in [0, 255], in the reference's
    order (photograph, MRI slice, two hillshaded elevation rasters),
    restricted to the names in `which`."""
    unknown = set(which) - set(TEXTURES)
    if unknown or not which:
        raise ValueError(f"textures must be a non-empty subset of "
                         f"{TEXTURES}, got {which}")
    d = SAMPLE_DATA
    texs = []
    if "hopper" in which:
        texs.append(read_gray8(d / "grace_hopper.png").astype(np.float32))
    if "mri" in which:
        # raw 256 x 256 big-endian uint16
        raw = gzip.decompress((d / "s1045.ima.gz").read_bytes())
        mri = np.frombuffer(raw, dtype=">u2").reshape(256, 256).astype(
            np.float32)
        texs.append(255.0 * (mri - mri.min()) / max(float(np.ptp(mri)), 1.0))
    for name, fname, key in (("topo", "topobathy.npz", "topo"),
                             ("dem", "jacksboro_fault_dem.npz",
                              "elevation")):
        if name in which:
            texs.append(_hillshade(np.load(d / fname)[key].astype(
                np.float32)))
    return [_enlarge_to_tile(t) for t in texs]


def _area_table(ssize: int, dsize: int):
    """OpenCV's INTER_AREA weights along one axis (imgproc/resize.cpp,
    computeResizeAreaTab) as dense (entries, dsize) index and float32
    weight arrays, the entries of an output pixel in OpenCV's order and
    padded with weight 0."""
    scale = 1.0 / (dsize / ssize)
    rows = [[] for _ in range(dsize)]
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx2 = min(math.floor(fsx2), ssize - 1)
        sx1 = min(math.ceil(fsx1), sx2)
        if sx1 - fsx1 > 1e-3:
            rows[dx].append((sx1 - 1, (sx1 - fsx1) / cell))
        rows[dx] += [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            rows[dx].append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
    m = max(len(r) for r in rows)
    idx = np.zeros((m, dsize), np.int64)
    wt = np.zeros((m, dsize), np.float32)
    for dx, r in enumerate(rows):
        for j, (s, a) in enumerate(r):
            idx[j, dx], wt[j, dx] = s, a
    return idx, wt


def resize_area(src: np.ndarray, size) -> np.ndarray:
    """`cv2.resize(src, size, interpolation=cv2.INTER_AREA)` of a float32
    image shrunk by a factor in [1, 2) per axis: the horizontal sums of
    each source row, then the vertical sums, accumulated in float32 in
    OpenCV's order (ResizeArea_Invoker)."""
    src = np.ascontiguousarray(src, np.float32)
    h, w = src.shape
    dw, dh = size
    if (h, w) == (dh, dw):
        return src.copy()
    if dw > w or dh > h:
        raise ValueError("resize_area only shrinks")
    ix, ax = _area_table(w, dw)
    iy, ay = _area_table(h, dh)
    rows = np.zeros((h, dw), np.float32)
    for j in range(len(ix)):
        rows = rows + src[:, ix[j]] * ax[j]
    out = ay[0][:, None] * rows[iy[0]]
    for j in range(1, len(iy)):
        out = out + ay[j][:, None] * rows[iy[j]]
    return out


def make_plane_texture(rng: np.random.RandomState, texs: list[np.ndarray],
                       size) -> np.ndarray:
    """Tile random crops / flips / rotations of the source images into an
    (h, w) float32 texture, with the reference's draws in its order."""
    h, w = size
    out = np.zeros((h, w), np.float32)
    tile = TILE
    for y0 in range(0, h, tile):
        for x0 in range(0, w, tile):
            t = texs[rng.randint(len(texs))]
            th, tw = t.shape
            ch = rng.randint(tile, min(2 * tile, th))
            cw = rng.randint(tile, min(2 * tile, tw))
            ys = rng.randint(0, th - ch + 1)
            xs = rng.randint(0, tw - cw + 1)
            crop = t[ys:ys + ch, xs:xs + cw]
            if rng.rand() < 0.5:
                crop = crop[:, ::-1]
            crop = np.rot90(crop, rng.randint(4))
            crop = resize_area(crop, (tile, tile))
            gain = rng.uniform(0.6, 1.1)
            bias = rng.uniform(0, 40)
            y1, x1 = min(y0 + tile, h), min(x0 + tile, w)
            out[y0:y1, x0:x1] = np.clip(crop[:y1 - y0, :x1 - x0] * gain + bias,
                                        0, 255)
    return out


# ---------------------------------------------------------------------------
# The raycaster
# ---------------------------------------------------------------------------

class Plane:
    """Finite textured rectangle: X(a,b) = origin + a*ex + b*ey, a,b in [0,1]."""

    def __init__(self, origin, ex, ey, texture):
        self.origin = np.asarray(origin, np.float64)
        self.ex = np.asarray(ex, np.float64)
        self.ey = np.asarray(ey, np.float64)
        self.tex = np.asarray(texture, np.float32)


# the packed textures of the last plane list rendered, kept on the device
# (the room's textures are 29 MB; the endoscopy surface's quads are rebuilt
# every frame around the same texture arrays): (key, the arrays, tensors)
_last_packed = None


def _packed_textures(planes, device):
    """(flat float32 texels, per-plane offset, width, height) on `device`."""
    global _last_packed
    key = (tuple(id(p.tex) for p in planes), str(device))
    if _last_packed is not None and _last_packed[0] == key:
        return _last_packed[2]
    sizes = np.array([p.tex.shape for p in planes], np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes[:, 0] * sizes[:, 1])[:-1]])
    flat = torch.as_tensor(np.concatenate([p.tex.ravel() for p in planes]),
                           device=device)
    out = (flat, torch.as_tensor(offs, device=device),
           torch.as_tensor(sizes[:, 1], device=device),
           torch.as_tensor(sizes[:, 0], device=device))
    # the arrays stay referenced, so their ids stay theirs
    _last_packed = (key, [p.tex for p in planes], out)
    return out


def _fma32(a, b, c):
    """float32 a * b + c rounded once (the product of two float32 values is
    exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _bilinear(flat, off, tw, th, mx, my):
    """`cv2.remap(tex, mx, my, INTER_LINEAR)` at float32 map coordinates
    inside [0, tw-1] x [0, th-1]: a horizontal lerp on the two rows, then a
    vertical one, each a fused multiply-add."""
    x0 = torch.floor(mx)
    y0 = torch.floor(my)
    fx = mx - x0
    fy = my - y0
    x0, y0 = x0.long(), y0.long()
    x1 = torch.minimum(x0 + 1, tw - 1)
    y1 = torch.minimum(y0 + 1, th - 1)
    v00 = flat[off + y0 * tw + x0]
    v01 = flat[off + y0 * tw + x1]
    v10 = flat[off + y1 * tw + x0]
    v11 = flat[off + y1 * tw + x1]
    r0 = _fma32(fx, v01 - v00, v00)
    r1 = _fma32(fx, v11 - v10, v10)
    return _fma32(fy, r1 - r0, r0)


def _pixel_dirs(size, intrinsics, device) -> torch.Tensor:
    """(H, W, 3) float64 rays (x/z, y/z, 1) of an undistorted pinhole."""
    Wl, Hl = size
    fx, fy, cx, cy = intrinsics
    us = torch.arange(Wl, dtype=torch.float64, device=device)[None, :]
    vs = torch.arange(Hl, dtype=torch.float64, device=device)[:, None]
    x = ((us - cx) / fx).expand(Hl, Wl)
    y = ((vs - cy) / fy).expand(Hl, Wl)
    return torch.stack([x, y, torch.ones_like(x)], -1)


def render(planes: list[Plane], R: np.ndarray, t: np.ndarray,
           near=0.05, far=60.0, size=None, intrinsics=None, dirs=None,
           device="cuda"):
    """Render (image uint8 (H, W), depth float32 (H, W), 0 where nothing is
    hit) from the world-to-camera pose (R, t): exact per-pixel ray / plane
    intersection, nearest hit, bilinear texture sampling.

    size=(W, H) / intrinsics=(fx, fy, cx, cy) override the TUM defaults;
    `dirs` ((H, W, 3), z = 1) overrides the per-pixel rays (the distorted
    EuRoC frames). The per-plane vectors are formed on the host in numpy as
    the reference forms them; every per-pixel quantity is computed on
    `device`."""
    Wl, Hl = size if size is not None else (W, H)
    intr = intrinsics if intrinsics is not None else (FX, FY, CX, CY)
    if dirs is None:
        d = _pixel_dirs((Wl, Hl), intr, device)
    else:
        d = torch.as_tensor(np.asarray(dirs, np.float64), device=device)
        Hl, Wl = d.shape[:2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]

    # per plane, on the host: the plane in the camera frame, its normal,
    # and the Gram matrix of its edges
    geo = []
    for pl in planes:
        p0 = R @ pl.origin + t
        e1 = R @ pl.ex
        e2 = R @ pl.ey
        n = np.cross(e1, e2)
        g11, g12, g22 = e1 @ e1, e1 @ e2, e2 @ e2
        geo.append([*p0, *e1, *e2, *n, float(n @ p0), g11, g12, g22,
                    g11 * g22 - g12 * g12])
    geo = torch.as_tensor(np.array(geo, np.float64), device=device)

    # nearest hit: the reference paints planes in order where z < zbuf
    # strictly, so a pixel ends with the first plane of least depth
    zbest = torch.full((Hl, Wl), math.inf, dtype=torch.float64,
                       device=device)
    best = torch.full((Hl, Wl), -1, dtype=torch.int64, device=device)
    abest = torch.zeros((Hl, Wl), dtype=torch.float64, device=device)
    bbest = torch.zeros_like(abest)
    for c0 in range(0, len(planes), PLANE_CHUNK):
        g = geo[c0:c0 + PLANE_CHUNK, :, None, None]        # (P, 20, 1, 1)
        (p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z, nx, ny, nz, num,
         g11, g12, g22, det) = g.unbind(1)
        denom = dx * nx + dy * ny + dz * nz                 # (P, H, W)
        z = num / denom               # ray parameter; rays have z = 1
        Xx = dx * z - p0x
        Xy = dy * z - p0y
        Xz = dz * z - p0z
        r1 = Xx * e1x + Xy * e1y + Xz * e1z
        r2 = Xx * e2x + Xy * e2y + Xz * e2z
        a = (g22 * r1 - g12 * r2) / det
        b = (g11 * r2 - g12 * r1) / det
        hit = (torch.isfinite(z) & (z > near) & (z < far)
               & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1))
        zc = torch.where(hit, z, math.inf)
        zmin, arg = torch.min(zc, 0)        # the first of equal depths
        take = zmin < zbest
        pick = arg[None]
        zbest = torch.where(take, zmin, zbest)
        best = torch.where(take, arg + c0, best)
        abest = torch.where(take, a.gather(0, pick)[0], abest)
        bbest = torch.where(take, b.gather(0, pick)[0], bbest)

    img = torch.zeros((Hl, Wl), dtype=torch.float32, device=device)
    valid = best >= 0
    if bool(valid.any()):
        flat, offs, tws, ths = _packed_textures(planes, device)
        k = best[valid]
        tw, th = tws[k], ths[k]
        twf, thf = (tw - 1).double(), (th - 1).double()
        mx = torch.minimum(torch.clamp(abest[valid] * twf, min=0.0),
                           twf).float()
        my = torch.minimum(torch.clamp(bbest[valid] * thf, min=0.0),
                           thf).float()
        img[valid] = _bilinear(flat, offs[k], tw, th, mx, my)
    depth = torch.where(torch.isfinite(zbest), zbest,
                        torch.zeros_like(zbest)).float()
    return img.to(torch.uint8).cpu().numpy(), depth.cpu().numpy()


def build_room(seed=0, which=TEXTURES) -> list[Plane]:
    """A 6 x 5 x 7 m room + interior slabs, every surface tiled from the
    source images in `which`."""
    rng = np.random.RandomState(seed)
    texs = load_real_textures(which)

    def T(h, w):
        return make_plane_texture(rng, texs, (h, w))

    planes = [
        # back wall  z=5, x in [-3,3], y in [-2.5, 2.5]
        Plane([-3, -2.5, 5], [6, 0, 0], [0, 5, 0], T(800, 960)),
        # floor y=+1.6
        Plane([-3, 1.6, -2], [6, 0, 0], [0, 0, 7], T(1120, 960)),
        # ceiling y=-1.9
        Plane([-3, -1.9, -2], [6, 0, 0], [0, 0, 7], T(1120, 960)),
        # left wall x=-3
        Plane([-3, -2.5, -2], [0, 0, 7], [0, 5, 0], T(800, 1120)),
        # right wall x=+3
        Plane([3, -2.5, -2], [0, 0, 7], [0, 5, 0], T(800, 1120)),
    ]
    # interior poster boards / slabs at varying depth for parallax
    for _ in range(6):
        cx_ = rng.uniform(-2.2, 2.2)
        cy_ = rng.uniform(-1.2, 1.2)
        cz = rng.uniform(2.0, 4.5)
        w = rng.uniform(0.6, 1.4)
        h = rng.uniform(0.5, 1.1)
        yaw = rng.uniform(-0.5, 0.5)
        ex = np.array([np.cos(yaw), 0, np.sin(yaw)]) * w
        ey = np.array([0, 1, 0]) * h
        planes.append(Plane([cx_ - ex[0] / 2, cy_ - h / 2, cz - ex[2] / 2],
                            ex, ey, T(320, 480)))
    return planes
