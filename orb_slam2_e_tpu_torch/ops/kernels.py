"""Hand-written CUDA kernel of the ORB front end, its plain torch twin, and
its build.

`fast_nms_blur_batch` replaces the reference's Pallas kernel
`orb_slam2_e_tpu/ops/pallas_kernels.py::fast_nms_blur` with
`csrc/fast_nms_blur.cu` (CUDA C++ for sm_90a, plain C entry point, loaded
with ctypes). It computes, for every level of the image pyramids of one or
more lanes (camera streams) in one kernel launch, the FAST-9/16 V-score with
the two-threshold bonus, 3x3 non-max suppression and the 7x7 sigma=2
Gaussian blur: the function of the reference's XLA path
(`orb.fast_score_map` + the NMS of `orb.detect_level` + `orb.gaussian_blur7`)
over the whole image, border included. `fast_nms_blur_pyramid` is its
one-lane case and `fast_nms_blur` its one-level case.

Tensors on the CPU go to the plain versions; CUDA tensors go to the kernel
or the call raises. Nothing falls back.

A shared library is built at first use by nvcc into `build/` beside this
package (`.gitignore` lists it), named by a hash of the source, so a changed
source rebuilds and concurrent processes never load a half-written file.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "fast_nms_blur.cu")
_BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_LEVELS = 64          # rows of the kernel's level table (csrc: MAX_LEVELS)
# each level's slice of the packed outputs starts on a 128-byte line
_OUT_ALIGN = 32          # float32 elements

# FAST ring (same Bresenham radius-3 circle as orb.FAST_RING), (dx, dy)
_RING = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
         (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2),
         (-1, -3))
_ARC = 9


def gaussian_taps7() -> np.ndarray:
    """7-tap Gaussian, sigma=2, float32 (orb._gaussian_kernel1d(2.0, 3))."""
    x = np.arange(-3, 4, dtype=np.float64)
    k = np.exp(-0.5 * (x / 2.0) ** 2)
    return (k / k.sum()).astype(np.float32)


_TAPS7 = gaussian_taps7()


# ---------------------------------------------------------------------------
# Plain torch version (CPU tests; the card-side comparison in chip_smoke.py)
# ---------------------------------------------------------------------------

def _pad2d(img: torch.Tensor, pad: int, mode: str, rows=True, cols=True):
    p = (pad if cols else 0, pad if cols else 0,
         pad if rows else 0, pad if rows else 0)
    return F.pad(img[None, None], p, mode=mode)[0, 0]


def _shift2d(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """View of img shifted by (dx, dy) with edge replication, same shape."""
    H, W = img.shape
    p = _pad2d(img, 3, "replicate")
    return p[3 + dy:3 + dy + H, 3 + dx:3 + dx + W]


def fast_score_map(img: torch.Tensor, th_high: float, th_low: float,
                   arc_len: int = _ARC) -> torch.Tensor:
    """FAST-9/16 V-score with the +1e4 bonus above `th_high`
    (orb.fast_score_map)."""
    ring = torch.stack([_shift2d(img, dx, dy) for dx, dy in _RING])
    d = ring - img[None]                                    # (16, H, W)

    def arc_strength(diff):
        dd = torch.cat([diff, diff[:arc_len - 1]], dim=0)   # (24, H, W)
        mins = dd[:16]
        for k in range(1, arc_len):
            mins = torch.minimum(mins, dd[k:k + 16])
        return torch.amax(mins, dim=0)

    v = torch.maximum(arc_strength(d), arc_strength(-d))
    zero = torch.zeros_like(v)
    return (torch.where(v > th_low, v, zero)
            + torch.where(v > th_high, torch.full_like(v, 1e4), zero))


def may_score(img: torch.Tensor, th_min: float) -> torch.Tensor:
    """Plain twin of the kernel's exact early reject: False where the
    V-score cannot exceed `th_min`. A 9-arc holds two neighbouring compass
    positions (0, 4, 8, 12) of the ring, so the score is at most the best
    over the four neighbour pairs of the smaller (negated) difference."""
    n, e, s, w = (_shift2d(img, *_RING[k]) - img for k in (0, 4, 8, 12))
    pairs = ((n, e), (e, s), (s, w), (w, n))
    bright = functools.reduce(torch.maximum,
                              [torch.minimum(a, b) for a, b in pairs])
    dark = functools.reduce(torch.minimum,
                            [torch.maximum(a, b) for a, b in pairs])
    return torch.maximum(bright, -dark) > th_min


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep a score where it is >= all 8 edge-clamped neighbours."""
    is_max = torch.ones_like(score, dtype=torch.bool)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            if dx or dy:
                is_max &= score >= _shift2d(score, dx, dy)
    return torch.where(is_max, score, torch.zeros_like(score))


def gaussian_blur7(img: torch.Tensor) -> torch.Tensor:
    """7x7 separable Gaussian, sigma=2, reflect-101 borders, rows first, in
    the reference's term order (orb.gaussian_blur7)."""
    H, W = img.shape
    k = torch.as_tensor(_TAPS7, device=img.device)
    x = _pad2d(img, 3, "reflect", cols=False)
    acc = k[0] * x[0:H]
    for i in range(1, 7):
        acc = acc + k[i] * x[i:i + H]
    x = _pad2d(acc, 3, "reflect", rows=False)
    acc = k[0] * x[:, 0:W]
    for i in range(1, 7):
        acc = acc + k[i] * x[:, i:i + W]
    return acc


def fast_nms_blur_plain(img: torch.Tensor, th_high: float, th_low: float):
    """Plain torch twin of the kernel's one-level case: (NMS'd score (H, W),
    blur (H, W))."""
    return (nms3x3(fast_score_map(img, th_high, th_low)),
            gaussian_blur7(img))


def fast_nms_blur_pyramid_plain(levels, th_high: float, th_low: float):
    """Plain torch twin of the kernel: [(score, blur)] level by level."""
    return [fast_nms_blur_plain(img, th_high, th_low) for img in levels]


# ---------------------------------------------------------------------------
# Build + launch
# ---------------------------------------------------------------------------

class _Lib:
    handle = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")


def compile_sources(sources):
    """Compile each .cu of `sources` into a shared library under `build/`
    (once per source hash), all nvcc processes started together. Returns
    [(library path, what ptxas reported, '' where the library was there)]."""
    jobs = []
    for src in sources:
        with open(src, "rb") as f:
            tag = hashlib.sha256(
                f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        stem = os.path.splitext(os.path.basename(src))[0]
        so_path = os.path.join(_BUILD_DIR, f"lib{stem}_{tag}.so")
        tmp = proc = None
        if not os.path.exists(so_path):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        jobs.append((src, so_path, tmp, proc))
    built, failed = [], []
    for src, so_path, tmp, proc in jobs:
        log = ""
        if proc is not None:
            log = proc.communicate()[0]
            if proc.returncode == 0:
                os.replace(tmp, so_path)
            else:
                failed.append(f"nvcc failed on {src}:\n{log}")
                os.remove(tmp)
        built.append((so_path, log))
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


def build() -> ctypes.CDLL:
    """Compile csrc/fast_nms_blur.cu (once per source hash) and load it."""
    if _Lib.handle is not None:
        return _Lib.handle
    lib = ctypes.CDLL(compile_sources([_SRC])[0][0])
    lib.fast_nms_blur_pyramid_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    lib.fast_nms_blur_pyramid_launch.restype = ctypes.c_int
    _Lib.handle = lib
    return lib


def batch_layout(shapes, n_lanes: int):
    """Where level l of lane b lies in the packed output buffers of B lanes
    with the same level shapes: ([[element offset of lane b] per level],
    total elements). The lanes of one level form a contiguous (n_lanes, H, W)
    block, whose offset is a multiple of 32 elements, so the block is the
    level's batched view."""
    offsets, total = [], 0
    for h, w in shapes:
        offsets.append([total + b * h * w for b in range(n_lanes)])
        total += -(-n_lanes * h * w // _OUT_ALIGN) * _OUT_ALIGN
    return offsets, total


def pyramid_layout(shapes):
    """`batch_layout` of one lane: ([element offset per level], total)."""
    offsets, total = batch_layout(shapes, 1)
    return [o for o, in offsets], total


def pyramid_views(packed: torch.Tensor, shapes):
    """The (H, W) view of each level in a packed one-lane buffer."""
    offsets, _ = pyramid_layout(shapes)
    return [packed[o:o + h * w].view(h, w)
            for (h, w), o in zip(shapes, offsets)]


@functools.lru_cache(maxsize=64)
def _level_table(shapes, offsets):
    """The host arrays the launch passes for a tuple of (H, W) shapes and
    their element offsets."""
    n = len(shapes)
    return ((ctypes.c_int * n)(*[h for h, _ in shapes]),
            (ctypes.c_int * n)(*[w for _, w in shapes]),
            (ctypes.c_longlong * n)(*offsets))


def _check_levels(levels):
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"expected 1..{MAX_LEVELS} levels, got {len(levels)}")
    for img in levels:
        if img.dtype != torch.float32 or img.dim() != 2:
            raise ValueError(f"expected a 2-D float32 image, got {img.dtype} "
                             f"{tuple(img.shape)}")
        if not img.is_contiguous():
            raise ValueError("image must be contiguous")
        if img.shape[0] < 4 or img.shape[1] < 4:
            raise ValueError(f"image {img.shape[0]}x{img.shape[1]} is below "
                             "the 4x4 the borders need")
        if img.device != levels[0].device:
            raise ValueError("levels lie on different devices")
    if levels[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {levels[0].device}")


def launch_into(levels, score: torch.Tensor, blur: torch.Tensor,
                th_high: float, th_low: float, offsets) -> None:
    """One kernel launch on the current stream: every level of `levels`
    (1..64, checked by the caller) into the packed float32 buffers `score`
    and `blur`, level k at the element offset `offsets[k]` (a tuple).
    Allocates nothing on the device; adds one to `fast_nms_blur.launches`."""
    lib = build()
    dev = levels[0].device
    heights, widths, offsets = _level_table(
        tuple(tuple(img.shape) for img in levels), tuple(offsets))
    imgs = (ctypes.c_void_p * len(levels))(*[i.data_ptr() for i in levels])
    with torch.cuda.device(dev):
        err = lib.fast_nms_blur_pyramid_launch(
            imgs, heights, widths, offsets, len(levels), score.data_ptr(),
            blur.data_ptr(), float(th_high), float(th_low),
            _TAPS7.ctypes.data, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fast_nms_blur launch failed: CUDA error {err}")
    fast_nms_blur.launches += 1


def fast_nms_blur_batch(levels_per_lane, th_high: float, th_low: float):
    """Fused FAST score -> 3x3 NMS, and 7x7 blur, of every level of the
    pyramids of B lanes (camera streams).

    levels_per_lane: B lists of 1..64 (H, W) float32 contiguous tensors,
    H, W >= 4, all on one device, every lane with the same level shapes
    (shapes may differ between levels). Returns [(score (B, H, W), blur
    (B, H, W))] per level. CPU tensors take the plain torch version lane by
    lane. CUDA tensors take the kernel: ONE launch while B x levels <= 64,
    else one launch per group of 64 // levels lanes. The outputs of a level
    are views of two packed buffers allocated by this call."""
    lanes = [list(levels) for levels in levels_per_lane]
    shapes = [tuple(img.shape) for img in lanes[0]]
    if any([tuple(img.shape) for img in levels] != shapes
           for levels in lanes):
        raise ValueError("lanes differ in their level shapes")
    for levels in lanes:
        _check_levels(levels)
    dev = lanes[0][0].device
    if any(img.device != dev for levels in lanes for img in levels):
        raise ValueError("lanes lie on different devices")
    if dev.type == "cpu":
        per_lane = [fast_nms_blur_pyramid_plain(levels, th_high, th_low)
                    for levels in lanes]
        return [tuple(torch.stack([lane[lvl][i] for lane in per_lane])
                      for i in (0, 1)) for lvl in range(len(shapes))]
    offsets, total = batch_layout(shapes, len(lanes))
    packed = torch.empty((2, total), dtype=torch.float32, device=dev)
    per_launch = MAX_LEVELS // len(shapes)
    for b0 in range(0, len(lanes), per_launch):
        group = range(b0, min(b0 + per_launch, len(lanes)))
        launch_into([img for b in group for img in lanes[b]], packed[0],
                    packed[1], th_high, th_low,
                    [offsets[lvl][b] for b in group
                     for lvl in range(len(shapes))])
    out = []
    for (h, w), lane_offsets in zip(shapes, offsets):
        o, n = lane_offsets[0], len(lanes) * h * w
        out.append((packed[0, o:o + n].view(-1, h, w),
                    packed[1, o:o + n].view(-1, h, w)))
    return out


def fast_nms_blur_pyramid(levels, th_high: float, th_low: float):
    """The one-lane case of `fast_nms_blur_batch`: [(score, blur)] per level
    of one pyramid of 1..64 (H, W) levels, in ONE launch on the card."""
    return [(score[0], blur[0]) for score, blur in
            fast_nms_blur_batch([levels], th_high, th_low)]


def fast_nms_blur(img: torch.Tensor, th_high: float, th_low: float):
    """The one-level case of `fast_nms_blur_pyramid`: (score, blur) of one
    (H, W) float32 image. `fast_nms_blur.launches` counts every launch of
    the kernel, whichever entry made it."""
    return fast_nms_blur_pyramid([img], th_high, th_low)[0]


fast_nms_blur.launches = 0
