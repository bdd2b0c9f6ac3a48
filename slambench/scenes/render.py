"""The benchmark's scene: a textured room and its exact raycaster.

A frozen copy of the port's proxy-room generator
(`orb_slam2_e_tpu_torch/tools/proxy_render.py`), so that what the benchmark
renders never moves with the program. Every plane texture is tiled from
random crops of four real images (`sample_data/`); `Room.render`
intersects each pixel's ray with every plane, keeps the nearest hit and
samples its texture bilinearly, in float64 on the device it is given.

What differs from the copied generator:
- the photograph is decoded by this module's own PNG reader;
- the room's layout (where its interior slabs stand) and its textures
  come from two seeds of their own, both fixed by the traffic mix;
- a sixth wall closes the room behind the camera's start;
- the packed textures are held by the `Room`, not by the module.
"""

from __future__ import annotations

import gzip
import math
import struct
import zlib
from pathlib import Path

import numpy as np
import torch

SAMPLE_DATA = Path(__file__).resolve().parent / "sample_data"
TEXTURES = ("hopper", "mri", "topo", "dem")
PLANE_CHUNK = 16      # planes intersected per batch of tensor operations
TILE = 160            # texture tile side, px


# ---------------------------------------------------------------------------
# Source imagery
# ---------------------------------------------------------------------------

def read_grey_png(path) -> np.ndarray:
    """(H, W) uint8 of an 8-bit grey, non-interlaced PNG whose rows are
    filtered by none or up."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, colour, _, _, interlace = hdr
    if (depth, colour, interlace) != (8, 0, 0):
        raise ValueError(f"{path}: only 8-bit grey non-interlaced PNGs")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, w + 1)
    # each row's filter: 0 (none) or 2 (up), the two the shipped
    # photograph uses
    if not set(np.unique(raw[:, 0]).tolist()) <= {0, 2}:
        raise ValueError(f"{path}: a PNG filter other than none / up")
    out = raw[:, 1:].copy()
    for y in range(1, h):
        if raw[y, 0] == 2:
            out[y] += out[y - 1]          # uint8 wraps modulo 256
    return out


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


def load_textures() -> list[np.ndarray]:
    """The four source images as float32 grey in [0, 255]: photograph, MRI
    slice, two hillshaded elevation rasters."""
    d = SAMPLE_DATA
    texs = [read_grey_png(d / "grace_hopper.png").astype(np.float32)]
    raw = gzip.decompress((d / "s1045.ima.gz").read_bytes())
    mri = np.frombuffer(raw, dtype=">u2").reshape(256, 256).astype(
        np.float32)
    texs.append(255.0 * (mri - mri.min()) / max(float(np.ptp(mri)), 1.0))
    texs.append(_hillshade(np.load(d / "topobathy.npz")["topo"].astype(
        np.float32)))
    texs.append(_hillshade(np.load(d / "jacksboro_fault_dem.npz")[
        "elevation"].astype(np.float32)))
    return [_enlarge_to_tile(t) for t in texs]


def _area_table(ssize: int, dsize: int):
    """OpenCV's INTER_AREA weights along one axis as dense (entries, dsize)
    index and float32 weight arrays."""
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
    """An area-weighted shrink of a float32 image by a factor in [1, 2)
    per axis (OpenCV's INTER_AREA)."""
    src = np.ascontiguousarray(src, np.float32)
    h, w = src.shape
    dw, dh = size
    if (h, w) == (dh, dw):
        return src.copy()
    ix, ax = _area_table(w, dw)
    iy, ay = _area_table(h, dh)
    rows = np.zeros((h, dw), np.float32)
    for j in range(len(ix)):
        rows = rows + src[:, ix[j]] * ax[j]
    out = ay[0][:, None] * rows[iy[0]]
    for j in range(1, len(iy)):
        out = out + ay[j][:, None] * rows[iy[j]]
    return out


def make_plane_texture(rng: np.random.RandomState, texs, size) -> np.ndarray:
    """Tile random crops / flips / rotations of the source images into an
    (h, w) float32 texture."""
    h, w = size
    out = np.zeros((h, w), np.float32)
    for y0 in range(0, h, TILE):
        for x0 in range(0, w, TILE):
            t = texs[rng.randint(len(texs))]
            th, tw = t.shape
            ch = rng.randint(TILE, min(2 * TILE, th))
            cw = rng.randint(TILE, min(2 * TILE, tw))
            ys = rng.randint(0, th - ch + 1)
            xs = rng.randint(0, tw - cw + 1)
            crop = t[ys:ys + ch, xs:xs + cw]
            if rng.rand() < 0.5:
                crop = crop[:, ::-1]
            crop = np.rot90(crop, rng.randint(4))
            crop = resize_area(crop, (TILE, TILE))
            gain = rng.uniform(0.6, 1.1)
            bias = rng.uniform(0, 40)
            y1, x1 = min(y0 + TILE, h), min(x0 + TILE, w)
            out[y0:y1, x0:x1] = np.clip(crop[:y1 - y0, :x1 - x0] * gain + bias,
                                        0, 255)
    return out


# ---------------------------------------------------------------------------
# The room and its raycaster
# ---------------------------------------------------------------------------

class Plane:
    """Finite textured rectangle: X(a, b) = origin + a ex + b ey, with a
    and b in [0, 1]."""

    def __init__(self, origin, ex, ey, texture):
        self.origin = np.asarray(origin, np.float64)
        self.ex = np.asarray(ex, np.float64)
        self.ey = np.asarray(ey, np.float64)
        self.tex = np.asarray(texture, np.float32)


def room_planes(texture_seed: int, layout_seed: int) -> list[Plane]:
    """A 6 x 5 x 7 m room and six interior slabs: where the slabs stand
    comes from `layout_seed`, every texture from `texture_seed`."""
    trng = np.random.RandomState(texture_seed)
    lrng = np.random.RandomState(layout_seed)
    texs = load_textures()

    def T(h, w):
        return make_plane_texture(trng, texs, (h, w))

    planes = [
        Plane([-3, -2.5, 5], [6, 0, 0], [0, 5, 0], T(800, 960)),   # back z=5
        Plane([-3, 1.6, -2], [6, 0, 0], [0, 0, 7], T(1120, 960)),  # floor
        Plane([-3, -1.9, -2], [6, 0, 0], [0, 0, 7], T(1120, 960)),  # ceiling
        Plane([-3, -2.5, -2], [0, 0, 7], [0, 5, 0], T(800, 1120)),  # x=-3
        Plane([3, -2.5, -2], [0, 0, 7], [0, 5, 0], T(800, 1120)),   # x=+3
        Plane([-3, -2.5, -2], [6, 0, 0], [0, 5, 0], T(800, 960)),  # front z=-2
    ]
    for _ in range(6):
        cx_ = lrng.uniform(-2.2, 2.2)
        cy_ = lrng.uniform(-1.2, 1.2)
        cz = lrng.uniform(2.0, 4.5)
        w = lrng.uniform(0.6, 1.4)
        h = lrng.uniform(0.5, 1.1)
        yaw = lrng.uniform(-0.5, 0.5)
        ex = np.array([np.cos(yaw), 0, np.sin(yaw)]) * w
        ey = np.array([0, 1, 0]) * h
        planes.append(Plane([cx_ - ex[0] / 2, cy_ - h / 2, cz - ex[2] / 2],
                            ex, ey, T(320, 480)))
    return planes


def _fma32(a, b, c):
    """float32 a * b + c rounded once."""
    return (a.double() * b.double() + c.double()).float()


def _bilinear(flat, off, tw, th, mx, my):
    """Bilinear texture lookup at float32 coordinates inside the texture."""
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


class Room:
    """The planes of one room with their textures packed on `device`."""

    def __init__(self, planes: list[Plane], device):
        self.planes = planes
        self.device = torch.device(device)
        sizes = np.array([p.tex.shape for p in planes], np.int64)
        offs = np.concatenate([[0], np.cumsum(sizes[:, 0] * sizes[:, 1])[:-1]])
        self.flat = torch.as_tensor(np.concatenate(
            [p.tex.ravel() for p in planes]), device=self.device)
        self.offs = torch.as_tensor(offs, device=self.device)
        self.tws = torch.as_tensor(sizes[:, 1], device=self.device)
        self.ths = torch.as_tensor(sizes[:, 0], device=self.device)

    def render(self, R: np.ndarray, t: np.ndarray, dirs: torch.Tensor,
               near=0.05, far=60.0):
        """(image uint8 (H, W), depth float32 (H, W), 0 where nothing is
        hit) on the room's device, from the world-to-camera pose (R, t)
        along the per-pixel rays `dirs` ((H, W, 3) float64, z = 1)."""
        d = dirs
        Hl, Wl = d.shape[:2]
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        geo = []
        for pl in self.planes:
            p0 = R @ pl.origin + t
            e1 = R @ pl.ex
            e2 = R @ pl.ey
            n = np.cross(e1, e2)
            g11, g12, g22 = e1 @ e1, e1 @ e2, e2 @ e2
            geo.append([*p0, *e1, *e2, *n, float(n @ p0), g11, g12, g22,
                        g11 * g22 - g12 * g12])
        geo = torch.as_tensor(np.array(geo, np.float64), device=self.device)
        zbest = torch.full((Hl, Wl), math.inf, dtype=torch.float64,
                           device=self.device)
        best = torch.full((Hl, Wl), -1, dtype=torch.int64, device=self.device)
        abest = torch.zeros((Hl, Wl), dtype=torch.float64, device=self.device)
        bbest = torch.zeros_like(abest)
        for c0 in range(0, len(self.planes), PLANE_CHUNK):
            g = geo[c0:c0 + PLANE_CHUNK, :, None, None]
            (p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z, nx, ny, nz, num,
             g11, g12, g22, det) = g.unbind(1)
            denom = dx * nx + dy * ny + dz * nz
            z = num / denom
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
            zmin, arg = torch.min(zc, 0)
            take = zmin < zbest
            pick = arg[None]
            zbest = torch.where(take, zmin, zbest)
            best = torch.where(take, arg + c0, best)
            abest = torch.where(take, a.gather(0, pick)[0], abest)
            bbest = torch.where(take, b.gather(0, pick)[0], bbest)
        valid = best >= 0
        k = torch.where(valid, best, 0)
        tw, th = self.tws[k], self.ths[k]
        twf, thf = (tw - 1).double(), (th - 1).double()
        mx = torch.minimum(torch.clamp(abest * twf, min=0.0), twf).float()
        my = torch.minimum(torch.clamp(bbest * thf, min=0.0), thf).float()
        img = torch.where(valid, _bilinear(self.flat, self.offs[k], tw, th,
                                           mx, my),
                          torch.zeros((), device=self.device))
        depth = torch.where(torch.isfinite(zbest), zbest,
                            torch.zeros_like(zbest)).float()
        return img.to(torch.uint8), depth
