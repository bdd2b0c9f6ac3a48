"""Hand-written CUDA kernel of the ORB front end, its plain torch twin, and
its build.

`fast_nms_blur` replaces the reference's Pallas kernel
`orb_slam2_e_tpu/ops/pallas_kernels.py::fast_nms_blur` with
`csrc/fast_nms_blur.cu` (CUDA C++ for sm_90a, plain C entry point, loaded
with ctypes). It computes, for one pyramid level, the FAST-9/16 V-score with
the two-threshold bonus, 3x3 non-max suppression and the 7x7 sigma=2
Gaussian blur — the function of the reference's XLA path
(`orb.fast_score_map` + the NMS of `orb.detect_level` + `orb.gaussian_blur7`)
over the whole image, border included.

A tensor on the CPU goes to `fast_nms_blur_plain`; a CUDA tensor goes to the
kernel or the call raises. Nothing falls back.

The shared library is built at first use by nvcc into `build/` beside this
package (`.gitignore` lists it), named by a hash of the source, so a changed
source rebuilds and concurrent processes never load a half-written file.
"""

from __future__ import annotations

import ctypes
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
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

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
    """Plain torch twin of the kernel: (NMS'd score (H, W), blur (H, W))."""
    return (nms3x3(fast_score_map(img, th_high, th_low)),
            gaussian_blur7(img))


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


def build() -> ctypes.CDLL:
    """Compile csrc/fast_nms_blur.cu (once per source hash) and load it."""
    if _Lib.handle is not None:
        return _Lib.handle
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    so_path = os.path.join(_BUILD_DIR, f"libfast_nms_blur_{tag}.so")
    if not os.path.exists(so_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, so_path)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"nvcc failed:\n{e.stderr}") from e
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(so_path)
    lib.fast_nms_blur_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.fast_nms_blur_launch.restype = ctypes.c_int
    _Lib.handle = lib
    return lib


def fast_nms_blur(img: torch.Tensor, th_high: float, th_low: float):
    """Fused FAST score -> 3x3 NMS, and 7x7 blur, of one pyramid level.

    img: (H, W) float32, contiguous, H, W >= 4. Returns (score, blur), both
    (H, W) float32. CPU tensors take the plain torch version; CUDA tensors
    take the kernel, and `fast_nms_blur.launches` counts each launch."""
    if img.dtype != torch.float32 or img.dim() != 2:
        raise ValueError(f"expected a 2-D float32 image, got {img.dtype} "
                         f"{tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("image must be contiguous")
    H, W = img.shape
    if H < 4 or W < 4:
        raise ValueError(f"image {H}x{W} is below the 4x4 the borders need")
    if img.device.type == "cpu":
        return fast_nms_blur_plain(img, th_high, th_low)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    lib = build()
    score = torch.empty_like(img)
    blur = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.fast_nms_blur_launch(
            img.data_ptr(), score.data_ptr(), blur.data_ptr(), H, W,
            float(th_high), float(th_low), _TAPS7.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"fast_nms_blur launch failed: CUDA error {err}")
    fast_nms_blur.launches += 1
    return score, blur


fast_nms_blur.launches = 0
