"""The plain ORB extractor the benchmark holds the program's extraction to.

A frozen plain-torch copy of the port's extractor
(`orb_slam2_e_tpu_torch/ops/orb.py` with the plain twin of its CUDA kernel,
`ops/kernels.py::fast_nms_blur_plain`): the antialiased bilinear pyramid,
FAST-9/16 with the two-threshold bonus, 3x3 non-max suppression, one best
corner per 16-pixel cell, per-level quotas, intensity-centroid angles and
the steered 256-bit descriptor from the 7x7 sigma-2 blur.

`dtype` is the precision the pyramid, the scores, the blur and the moments
are computed in: float32 is the configuration's, bfloat16 the control's.
Nothing here imports the program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

HALF_PATCH = 15
EDGE_THRESHOLD = 19
PATTERN_BITS = 256
RING = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2),
        (-1, -3))
ARC = 9
SCAN_BASE = 16
ATAN2_ROW = 64


def make_pattern(seed: int = 1234) -> np.ndarray:
    """The 256-pair binary test pattern, (256, 2, 2) int32 (x, y)."""
    rng = np.random.RandomState(seed)
    sigma = (2 * HALF_PATCH + 1) / 5.0
    return np.clip(np.round(rng.randn(PATTERN_BITS, 2, 2) * sigma),
                   -HALF_PATCH, HALF_PATCH).astype(np.int32)


PATTERN = make_pattern()
CHORD_XMAX = np.array([int(np.floor(np.sqrt(HALF_PATCH ** 2 - dy ** 2)))
                       for dy in range(-HALF_PATCH, HALF_PATCH + 1)],
                      dtype=np.int32)


def gaussian_taps7() -> np.ndarray:
    x = np.arange(-3, 4, dtype=np.float64)
    k = np.exp(-0.5 * (x / 2.0) ** 2)
    return (k / k.sum()).astype(np.float32)


def level_quotas(n_features: int, scale_factor: float, n_levels: int):
    factor = 1.0 / scale_factor
    n_per = n_features * (1 - factor) / (1 - factor ** n_levels)
    quotas, total = [], 0
    for _ in range(n_levels - 1):
        q = int(round(n_per))
        quotas.append(q)
        total += q
        n_per *= factor
    quotas.append(max(n_features - total, 0))
    return quotas


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float32 weights of the antialiased triangle-kernel resize."""
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
    w.flags.writeable = False
    return w


def _pad2d(img, pad, mode, rows=True, cols=True):
    p = (pad if cols else 0, pad if cols else 0,
         pad if rows else 0, pad if rows else 0)
    return F.pad(img[None, None], p, mode=mode)[0, 0]


def _shift2d(img, dx, dy):
    H, W = img.shape
    p = _pad2d(img, 3, "replicate")
    return p[3 + dy:3 + dy + H, 3 + dx:3 + dx + W]


def fast_score_map(img, th_high, th_low):
    """FAST-9/16 V-score with the +1e4 bonus above `th_high`."""
    ring = torch.stack([_shift2d(img, dx, dy) for dx, dy in RING])
    d = ring - img[None]

    def arc_strength(diff):
        dd = torch.cat([diff, diff[:ARC - 1]], dim=0)
        mins = dd[:16]
        for k in range(1, ARC):
            mins = torch.minimum(mins, dd[k:k + 16])
        return torch.amax(mins, dim=0)

    v = torch.maximum(arc_strength(d), arc_strength(-d))
    zero = torch.zeros_like(v)
    return (torch.where(v > th_low, v, zero)
            + torch.where(v > th_high, torch.full_like(v, 1e4), zero))


def nms3x3(score):
    is_max = torch.ones_like(score, dtype=torch.bool)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            if dx or dy:
                is_max &= score >= _shift2d(score, dx, dy)
    return torch.where(is_max, score, torch.zeros_like(score))


def gaussian_blur7(img):
    """7x7 separable Gaussian, sigma 2, reflect-101 borders, rows first."""
    H, W = img.shape
    k = torch.as_tensor(gaussian_taps7(), device=img.device).to(img.dtype)
    x = _pad2d(img, 3, "reflect", cols=False)
    acc = k[0] * x[0:H]
    for i in range(1, 7):
        acc = acc + k[i] * x[i:i + H]
    x = _pad2d(acc, 3, "reflect", rows=False)
    acc = k[0] * x[:, 0:W]
    for i in range(1, 7):
        acc = acc + k[i] * x[:, i:i + W]
    return acc


def cumsum_rows(a):
    """Cumulative sum along the last axis by a blocked scan of base 16."""
    n = a.shape[-1]
    nb = -(-n // SCAN_BASE)
    blocks = F.pad(a, (0, nb * SCAN_BASE - n)).reshape(
        a.shape[:-1] + (nb, SCAN_BASE))
    cols = [blocks[..., 0]]
    for i in range(1, SCAN_BASE):
        cols.append(cols[-1] + blocks[..., i])
    within = torch.stack(cols, dim=-1)
    if nb == 1:
        return within.reshape(a.shape[:-1] + (SCAN_BASE,))[..., :n]
    prefix = cumsum_rows(within[..., -1])
    excl = F.pad(prefix[..., :-1], (1, 0))
    return (within + excl[..., None]).reshape(
        a.shape[:-1] + (nb * SCAN_BASE,))[..., :n]


def orientation_moment_maps(img):
    """Dense maps of the intensity-centroid moments m10, m01."""
    H, W = img.shape
    r = HALF_PATCH
    pad = r + 1
    xs = torch.arange(W, dtype=img.dtype, device=img.device)[None, :].expand(
        H, W)

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

    m01 = torch.zeros((H, W), dtype=img.dtype, device=img.device)
    m10 = torch.zeros_like(m01)
    for dy in range(-r, r + 1):
        xm = int(CHORD_XMAX[dy + r])
        S = chord(CxI, dy, xm)
        m10 = m10 + chord(CxX, dy, xm) - xs * S
        if dy != 0:
            m01 = m01 + float(dy) * S
    return m10, m01


def orientations(m10, m01, uv):
    H, W = m10.shape
    pix = uv.to(torch.int64)
    x = torch.clamp(pix[:, 0], 0, W - 1)
    y = torch.clamp(pix[:, 1], 0, H - 1)
    flat = y * W + x
    n = flat.shape[0]
    pad = (0, -n % ATAN2_ROW)
    return torch.atan2(F.pad(m01.reshape(-1)[flat].float(), pad),
                       F.pad(m10.reshape(-1)[flat].float(), pad))[:n]


def descriptors(blur, uv, angle):
    """Steered 256-bit binary descriptors, packed (N, 32) uint8."""
    H, W = blur.shape
    dev = blur.device
    flat = blur.reshape(-1)
    ca, sa = torch.cos(angle), torch.sin(angle)
    pat = torch.as_tensor(PATTERN, dtype=torch.float32, device=dev)
    px, py = pat[..., 0], pat[..., 1]
    rx = px[None] * ca[:, None, None] - py[None] * sa[:, None, None]
    ry = px[None] * sa[:, None, None] + py[None] * ca[:, None, None]
    cx = torch.clamp(torch.round(uv[:, None, None, 0] + rx), 0, W - 1)
    cy = torch.clamp(torch.round(uv[:, None, None, 1] + ry), 0, H - 1)
    vals = flat[cy.to(torch.int64) * W + cx.to(torch.int64)]
    bits = (vals[..., 0] < vals[..., 1]).to(torch.int32)
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
                           device=dev)
    return (bits.reshape(-1, 32, 8) * weights).sum(-1).to(torch.uint8)


def detect_level(score, quota, cell=16):
    """Up to `quota` corners, one best per cell, largest first."""
    H, W = score.shape
    dev = score.device
    b = EDGE_THRESHOLD
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    inb = (ys >= b) & (ys < H - b) & (xs >= b) & (xs < W - b)
    score = torch.where(inb, score, torch.zeros_like(score)).float()
    Cy, Cx = -(-H // cell), -(-W // cell)
    s = F.pad(score, (0, Cx * cell - W, 0, Cy * cell - H), value=-1.0)
    s = s.reshape(Cy, cell, Cx, cell).permute(0, 2, 1, 3).reshape(
        Cy, Cx, cell * cell)
    best = torch.argmax(s, dim=-1)
    cs = torch.amax(s, dim=-1).reshape(-1)
    cv = (torch.arange(Cy, device=dev)[:, None] * cell + best // cell
          ).reshape(-1)
    cu = (torch.arange(Cx, device=dev)[None, :] * cell + best % cell
          ).reshape(-1)
    k = min(quota, cs.shape[0])
    vals, idx = torch.sort(cs, descending=True, stable=True)
    top_s, idx = vals[:k], idx[:k]
    uv = torch.stack([cu[idx], cv[idx]], dim=-1).to(torch.float32)
    valid = top_s > 0.0
    if k < quota:
        pad = quota - k
        uv = torch.cat([uv, torch.zeros((pad, 2), device=dev)])
        top_s = torch.cat([top_s, torch.zeros((pad,), device=dev)])
        valid = torch.cat([valid, torch.zeros((pad,), dtype=torch.bool,
                                              device=dev)])
    return uv, valid


class Extractor:
    """ORB features of one grey image: (uv level-0 px (N, 2), octave (N,),
    desc (N, 32) uint8, valid (N,))."""

    def __init__(self, n_features, scale_factor, n_levels, ini_th, min_th,
                 dtype=torch.float32):
        self.quotas = level_quotas(n_features, scale_factor, n_levels)
        self.scales = [scale_factor ** i for i in range(n_levels)]
        self.ini_th, self.min_th = float(ini_th), float(min_th)
        self.dtype = dtype

    def pyramid(self, image):
        img0 = torch.as_tensor(image).to(torch.float32)
        H, W = img0.shape
        out = [img0.to(self.dtype)]
        for s in self.scales[1:]:
            h, w = int(round(H / s)), int(round(W / s))
            wh = torch.tensor(resize_weights(H, h), device=img0.device)
            ww = torch.tensor(resize_weights(W, w), device=img0.device)
            out.append((wh.T.to(self.dtype) @ img0.to(self.dtype)
                        @ ww.to(self.dtype)).contiguous())
        return out

    def __call__(self, image):
        uvs, octs, descs, valids = [], [], [], []
        for lvl, img in enumerate(self.pyramid(image)):
            score = nms3x3(fast_score_map(img, self.ini_th, self.min_th))
            blur = gaussian_blur7(img)
            uv, valid = detect_level(score, self.quotas[lvl])
            m10, m01 = orientation_moment_maps(img)
            ang = orientations(m10, m01, uv)
            desc = descriptors(blur, uv, ang)
            uvs.append(uv * torch.tensor(self.scales[lvl],
                                         dtype=torch.float32,
                                         device=uv.device))
            octs.append(torch.full((uv.shape[0],), lvl, dtype=torch.int32,
                                   device=uv.device))
            descs.append(desc)
            valids.append(valid)
        return (torch.cat(uvs), torch.cat(octs), torch.cat(descs),
                torch.cat(valids))


def level_images(image, scale_factor, n_levels):
    """The float32 pyramid levels of `image` (what the extraction's
    per-pixel stage reads)."""
    return Extractor(1, scale_factor, n_levels, 20, 7).pyramid(image)


def may_score(img, th_min):
    """False where the FAST V-score cannot exceed `th_min`: a 9-arc holds
    two neighbouring compass positions of the ring, so the score is at
    most the best over the four neighbour pairs of the smaller (negated)
    difference. The early reject of the kernel's work."""
    n, e, s, w = (_shift2d(img, *RING[k]) - img for k in (0, 4, 8, 12))
    pairs = ((n, e), (e, s), (s, w), (w, n))
    bright = functools.reduce(torch.maximum,
                              [torch.minimum(a, b) for a, b in pairs])
    dark = functools.reduce(torch.minimum,
                            [torch.maximum(a, b) for a, b in pairs])
    return torch.maximum(bright, -dark) > th_min
