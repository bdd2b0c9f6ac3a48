"""ORB feature extraction on torch tensors.

Port of `orb_slam2_e_tpu/ops/orb.py`: an 8-level scale pyramid, FAST with
the two-threshold bonus, 3x3 NMS, a cell grid with one best corner per cell,
per-level top-k quotas, intensity-centroid angles from dense moment maps and
the steered 256-bit descriptor with the same seeded pattern.

The per-pixel stage of all levels (FAST score + NMS + blur) is one call of
`kernels.fast_nms_blur_pyramid` per extraction: one launch of the
hand-written CUDA kernel on the card, its plain torch twin on the CPU.
`OrbExtractor.extract_batch` extracts B images of one size with one launch
of the kernel over all B pyramids (while B x levels <= 64), and the
per-level stages under `torch.vmap` over the lanes.

Where torch and JAX differ and the port chooses:
- pyramid resize: `jax.image.resize(..., 'bilinear')` is an antialiased
  triangle filter applied as two weight matrices; the port builds the same
  matrices on the host (float32, JAX's formula) and applies two f32 matmuls.
  Levels >= 1 agree with JAX-on-CPU to its own rounding, not bit for bit.
- top-k ties: `jax.lax.top_k` puts the lower index first; the port takes the
  first k of a stable descending sort.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import kernels

HALF_PATCH = 15
EDGE_THRESHOLD = 19
PATTERN_BITS = 256


def make_pattern(seed: int = 1234) -> np.ndarray:
    """The 256-pair binary test pattern, (256, 2, 2) int32 (x, y); the same
    numpy draw as the reference, so it is bit-identical."""
    rng = np.random.RandomState(seed)
    sigma = (2 * HALF_PATCH + 1) / 5.0
    pts = np.clip(np.round(rng.randn(PATTERN_BITS, 2, 2) * sigma),
                  -HALF_PATCH, HALF_PATCH).astype(np.int32)
    return pts


_PATTERN = make_pattern()

# the per-pixel stage's plain functions, under the reference's names
fast_score_map = kernels.fast_score_map
gaussian_blur7 = kernels.gaussian_blur7

# per-row half-chord widths of the radius-15 disc (index dy+15)
_CHORD_XMAX = np.array([int(np.floor(np.sqrt(HALF_PATCH ** 2 - dy ** 2)))
                        for dy in range(-HALF_PATCH, HALF_PATCH + 1)],
                       dtype=np.int32)


class OrbFeatures(NamedTuple):
    """Fixed-capacity keypoint SoA; coordinates in level-0 pixels."""
    uv: torch.Tensor        # (N, 2) float32 raw (distorted) pixel coords
    response: torch.Tensor  # (N,) float32 FAST score
    angle: torch.Tensor     # (N,) float32 radians
    octave: torch.Tensor    # (N,) int32 pyramid level
    desc: torch.Tensor      # (N, 32) uint8 packed 256-bit descriptor
    valid: torch.Tensor     # (N,) bool

    @property
    def capacity(self):
        return self.uv.shape[0]


def level_quotas(n_features: int, scale_factor: float, n_levels: int) -> list:
    """Per-level feature quotas: geometric split, remainder to the top level."""
    factor = 1.0 / scale_factor
    n_per = n_features * (1 - factor) / (1 - factor ** n_levels)
    quotas = []
    total = 0
    for _ in range(n_levels - 1):
        q = int(round(n_per))
        quotas.append(q)
        total += q
        n_per *= factor
    quotas.append(max(n_features - total, 0))
    return quotas


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of JAX's antialiased bilinear
    (triangle-kernel) resize, computed in float32 as
    jax/_src/image/scale.py::compute_weight_mat does."""
    f32 = np.float32
    scale = out_size / in_size
    inv_scale = f32(1.0 / scale)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.0) * inv_scale - f32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None])
         / kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, f32(0.0)).astype(f32)
    w.flags.writeable = False          # shared by every caller (cached)
    return w


def resize_bilinear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Antialiased bilinear resize of a (..., H, W) float32 image to
    (..., h, w)."""
    H, W = img.shape[-2:]
    wh = torch.tensor(resize_weights(H, h), device=img.device)
    ww = torch.tensor(resize_weights(W, w), device=img.device)
    return wh.T @ img @ ww


def _cell_argmax(score: torch.Tensor, cell: int):
    """Per-cell max + first argmax over a (H, W) map padded to cell
    multiples. Returns (cell_scores, cell_v, cell_u), each (Cy, Cx)."""
    H, W = score.shape
    Cy, Cx = -(-H // cell), -(-W // cell)
    s = torch.nn.functional.pad(score, (0, Cx * cell - W, 0, Cy * cell - H),
                                value=-1.0)
    s = s.reshape(Cy, cell, Cx, cell).permute(0, 2, 1, 3).reshape(
        Cy, Cx, cell * cell)
    best = torch.argmax(s, dim=-1)         # first maximal index, as jnp
    best_score = torch.amax(s, dim=-1)
    dv, du = best // cell, best % cell
    dev = score.device
    vv = torch.arange(Cy, device=dev, dtype=torch.int64)[:, None] * cell + dv
    uu = torch.arange(Cx, device=dev, dtype=torch.int64)[None, :] * cell + du
    return best_score, vv, uu


def top_k(x: torch.Tensor, k: int):
    """`jax.lax.top_k` over the last axis: largest first, lower index first
    among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def detect_level(score: torch.Tensor, quota: int, cell: int = 16):
    """Up to `quota` spread-out corners from an NMS'd score map.

    Returns (uv (Q, 2) f32 level coords, score (Q,), valid (Q,))."""
    H, W = score.shape
    dev = score.device
    b = EDGE_THRESHOLD
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    inb = (ys >= b) & (ys < H - b) & (xs >= b) & (xs < W - b)
    score = torch.where(inb, score, torch.zeros_like(score))
    cs, cv, cu = _cell_argmax(score, cell)
    flat_s, flat_v, flat_u = cs.reshape(-1), cv.reshape(-1), cu.reshape(-1)
    k = min(quota, flat_s.shape[0])
    top_s, idx = top_k(flat_s, k)
    uv = torch.stack([flat_u[idx], flat_v[idx]], dim=-1).to(torch.float32)
    valid = top_s > 0.0
    if k < quota:
        pad = quota - k
        uv = torch.cat([uv, torch.zeros((pad, 2), device=dev)])
        top_s = torch.cat([top_s, torch.zeros((pad,), device=dev)])
        valid = torch.cat([valid, torch.zeros((pad,), dtype=torch.bool,
                                              device=dev)])
    resp = torch.where(valid, torch.remainder(top_s, 1e4),
                       torch.zeros_like(top_s))
    return uv, resp, valid


_SCAN_BASE = 16


def cumsum_rows(a: torch.Tensor) -> torch.Tensor:
    """float32 cumulative sum along the last axis in the order XLA's CPU
    backend uses for `jnp.cumsum`: a recursive blocked scan of base 16
    (sequential sums inside each block of 16, the block totals scanned the
    same way, then each block's exclusive prefix added). Elementwise f32
    adds only, so the card and the CPU round alike; `torch.cumsum` would
    accumulate in double on the CPU."""
    n = a.shape[-1]
    nb = -(-n // _SCAN_BASE)
    blocks = torch.nn.functional.pad(a, (0, nb * _SCAN_BASE - n)).reshape(
        a.shape[:-1] + (nb, _SCAN_BASE))
    cols = [blocks[..., 0]]
    for i in range(1, _SCAN_BASE):
        cols.append(cols[-1] + blocks[..., i])
    within = torch.stack(cols, dim=-1)
    if nb == 1:
        return within.reshape(a.shape[:-1] + (_SCAN_BASE,))[..., :n]
    prefix = cumsum_rows(within[..., -1])
    excl = torch.nn.functional.pad(prefix[..., :-1], (1, 0))
    return (within + excl[..., None]).reshape(
        a.shape[:-1] + (nb * _SCAN_BASE,))[..., :n]


def orientation_moment_maps(img: torch.Tensor):
    """Dense (H, W) maps of the IC-angle moments m10, m01 from row cumsums
    of I and x*I and the 31 disc chords (orb.orientation_moment_maps)."""
    H, W = img.shape
    r = HALF_PATCH
    pad = r + 1
    F = torch.nn.functional
    xs = torch.arange(W, dtype=torch.float32,
                      device=img.device)[None, :].expand(H, W)

    def padded_cumsum(a):
        c = F.pad(cumsum_rows(a), (1, 0))
        return F.pad(c[None, None], (pad, pad, pad, pad),
                     mode="replicate")[0, 0]

    CxI = padded_cumsum(img)
    CxX = padded_cumsum(img * xs)

    def chord(Cp, dy, xm):
        hi = Cp[pad + dy:pad + dy + H, pad + xm + 1:pad + xm + 1 + W]
        lo = Cp[pad + dy:pad + dy + H, pad - xm:pad - xm + W]
        return hi - lo

    m01 = torch.zeros((H, W), dtype=torch.float32, device=img.device)
    m10 = torch.zeros_like(m01)
    for dy in range(-r, r + 1):
        xm = int(_CHORD_XMAX[dy + r])
        S = chord(CxI, dy, xm)
        m10 = m10 + chord(CxX, dy, xm) - xs * S
        if dy != 0:
            m01 = m01 + float(dy) * S
    return m10, m01


_ATAN2_ROW = 64


def orientations_from_maps(m10, m01, uv):
    """Angle per keypoint from the dense moment maps (2 gathers each).

    The atan2 runs on rows padded to a multiple of 64: torch's CPU loop
    takes whole vectors with its vectorized atan2 and the rest with the
    scalar one, which round differently, so without the padding a lane's
    angles would depend on how many lanes share the call."""
    H, W = m10.shape
    pix = uv.to(torch.int64)
    x = torch.clamp(pix[:, 0], 0, W - 1)
    y = torch.clamp(pix[:, 1], 0, H - 1)
    flat = y * W + x
    n = flat.shape[0]
    pad = (0, -n % _ATAN2_ROW)
    F = torch.nn.functional
    return torch.atan2(F.pad(m01.reshape(-1)[flat], pad),
                       F.pad(m10.reshape(-1)[flat], pad))[:n]


def _circular_mask_offsets(radius: int = HALF_PATCH) -> np.ndarray:
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    mask = (xs ** 2 + ys ** 2) <= radius ** 2
    return np.stack([xs[mask], ys[mask]], axis=-1).astype(np.int32)


_DISC = _circular_mask_offsets()


def compute_orientations(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle per keypoint, atan2(m01, m10) over the
    radius-15 disc gathered around each keypoint (reference IC_Angle).
    The extractor takes the same moments from `orientation_moment_maps`."""
    H, W = img.shape
    flat = img.reshape(-1)
    offs = torch.as_tensor(_DISC, device=img.device)          # (K, 2)
    pts = uv.to(torch.int32)[:, None, :] + offs[None]        # (N, K, 2)
    x = torch.clamp(pts[..., 0], 0, W - 1).to(torch.int64)
    y = torch.clamp(pts[..., 1], 0, H - 1).to(torch.int64)
    vals = flat[y * W + x]                                    # (N, K)
    offs = offs.to(torch.float32)
    m10 = torch.sum(vals * offs[None, :, 0], dim=1)
    m01 = torch.sum(vals * offs[None, :, 1], dim=1)
    return torch.atan2(m01, m10)


def compute_descriptors(img_blur: torch.Tensor, uv: torch.Tensor,
                        angle: torch.Tensor) -> torch.Tensor:
    """Steered 256-bit binary descriptor, packed (N, 32) uint8."""
    H, W = img_blur.shape
    dev = img_blur.device
    flat = img_blur.reshape(-1)
    ca, sa = torch.cos(angle), torch.sin(angle)
    pat = torch.as_tensor(_PATTERN, dtype=torch.float32, device=dev)
    px, py = pat[..., 0], pat[..., 1]                       # (256, 2)
    rx = px[None] * ca[:, None, None] - py[None] * sa[:, None, None]
    ry = px[None] * sa[:, None, None] + py[None] * ca[:, None, None]
    cx = torch.clamp(torch.round(uv[:, None, None, 0] + rx), 0, W - 1)
    cy = torch.clamp(torch.round(uv[:, None, None, 1] + ry), 0, H - 1)
    vals = flat[cy.to(torch.int64) * W + cx.to(torch.int64)]  # (N, 256, 2)
    bits = (vals[..., 0] < vals[..., 1]).to(torch.int32)
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
                           device=dev)
    return (bits.reshape(-1, 32, 8) * weights).sum(-1).to(torch.uint8)


class OrbExtractor:
    """Stateless extractor (reference ORBextractor::operator())."""

    def __init__(self, n_features: int = 1000, scale_factor: float = 1.2,
                 n_levels: int = 8, ini_th_fast: float = 20.0,
                 min_th_fast: float = 7.0, cell: int = 16):
        self.n_features = n_features
        self.scale_factor = scale_factor
        self.n_levels = n_levels
        self.ini_th = float(ini_th_fast)
        self.min_th = float(min_th_fast)
        self.cell = cell
        self.quotas = level_quotas(n_features, scale_factor, n_levels)
        self.capacity = sum(self.quotas)
        self.scales = [scale_factor ** i for i in range(n_levels)]

    def __call__(self, image: torch.Tensor) -> OrbFeatures:
        """image: (H, W) uint8 or float32 grayscale tensor."""
        return self._extract(image)

    def _pyramid(self, images: torch.Tensor) -> list:
        """The levels of (..., H, W) images, each resized from level 0, so
        all exist before the one kernel launch that scores and blurs them."""
        img0 = images.to(torch.float32).contiguous()
        H, W = img0.shape[-2:]
        return [img0] + [
            resize_bilinear(img0, int(round(H / s)),
                            int(round(W / s))).contiguous()
            for s in self.scales[1:]]

    def _level_features(self, lvl: int, img, smap, blurred) -> OrbFeatures:
        """Corners, angles and descriptors of one (H, W) level."""
        uv, score, valid = detect_level(smap, self.quotas[lvl], self.cell)
        m10, m01 = orientation_moment_maps(img)
        ang = orientations_from_maps(m10, m01, uv)
        desc = compute_descriptors(blurred, uv, ang)
        scale = torch.tensor(self.scales[lvl], dtype=torch.float32,
                             device=img.device)
        return OrbFeatures(
            uv=uv * scale, response=score, angle=ang,
            octave=torch.full((uv.shape[0],), lvl, dtype=torch.int32,
                              device=img.device),
            desc=desc, valid=valid)

    def _extract(self, image: torch.Tensor) -> OrbFeatures:
        levels = self._pyramid(image)
        maps = kernels.fast_nms_blur_pyramid(levels, self.ini_th, self.min_th)
        feats = [self._level_features(lvl, img, smap, blurred)
                 for lvl, (img, (smap, blurred)) in enumerate(zip(levels,
                                                                 maps))]
        return OrbFeatures(*[torch.cat([getattr(f, k) for f in feats])
                             for k in OrbFeatures._fields])

    def extract_batch(self, images: torch.Tensor) -> OrbFeatures:
        """images: (B, H, W) uint8 or float32, B camera streams of one size.
        One kernel launch scores and blurs all B pyramids (one per group of
        64 // n_levels lanes beyond B x n_levels = 64); the per-level stages
        run under `torch.vmap` over the lanes.
        Returns OrbFeatures with a leading B; lane b is `_extract(images[b])`
        (the resize is one pair of matmuls for all lanes)."""
        levels = self._pyramid(images)
        maps = kernels.fast_nms_blur_batch(
            [[img[b] for img in levels] for b in range(images.shape[0])],
            self.ini_th, self.min_th)
        feats = [torch.vmap(functools.partial(self._level_features, lvl))(
                     img, smap, blurred)
                 for lvl, (img, (smap, blurred)) in enumerate(zip(levels,
                                                                 maps))]
        return OrbFeatures(*[torch.cat([getattr(f, k) for f in feats], dim=1)
                             for k in OrbFeatures._fields])
