"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV.

Port of `orb_slam2_e_tpu/utils/datasets.py` (reference
Examples/Monocular/mono_tum.cc LoadImages :129-155, mono_kitti.cc,
mono_euroc.cc, Examples/RGB-D/rgbd_tum.cc with association files): the same
on-disk layouts work unchanged. The four list loaders are numpy and
`pathlib`; the image readers decode PNG files through `utils/imageio.py`
(`backend`: "auto", "libpng" or "numpy", see there) and anything else
through OpenCV, imported inside the function and asked for by name when it
is missing. Unlike the reference, no reader changes decoder silently when
one fails: the error is the decoder's own.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import imageio


def load_tum_rgb(seq_dir):
    """TUM: parse rgb.txt -> (timestamps, image paths)
    (reference mono_tum.cc:129)."""
    seq = Path(seq_dir)
    ts, paths = [], []
    for line in (seq / "rgb.txt").read_text().splitlines():
        line = line.strip()
        if not line or line.startswith('#'):
            continue
        t, p = line.split()[:2]
        ts.append(float(t))
        paths.append(str(seq / p))
    return np.asarray(ts), paths


def load_tum_associations(seq_dir, assoc_file):
    """TUM RGB-D with association file: (ts, rgb paths, depth paths)
    (reference rgbd_tum.cc LoadImages)."""
    seq = Path(seq_dir)
    ts, rgb, depth = [], [], []
    for line in Path(assoc_file).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith('#'):
            continue
        f = line.split()
        ts.append(float(f[0]))
        rgb.append(str(seq / f[1]))
        depth.append(str(seq / f[3]))
    return np.asarray(ts), rgb, depth


def load_kitti(seq_dir, stereo=False):
    """KITTI odometry: image_0 (+image_1), times.txt
    (reference mono_kitti.cc / stereo_kitti.cc LoadImages)."""
    seq = Path(seq_dir)
    ts = np.asarray([float(x) for x in
                     (seq / "times.txt").read_text().split()])
    left = sorted((seq / "image_0").glob("*.png"))
    if stereo:
        right = sorted((seq / "image_1").glob("*.png"))
        return ts, [str(p) for p in left], [str(p) for p in right]
    return ts, [str(p) for p in left]


def load_euroc(seq_dir, ts_file=None):
    """EuRoC MAV: mav0/cam0/data + data.csv timestamps
    (reference mono_euroc.cc LoadImages)."""
    seq = Path(seq_dir)
    cam0 = seq / "mav0" / "cam0"
    ts, paths = [], []
    if ts_file is not None:
        for line in Path(ts_file).read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            ts.append(float(line) / 1e9)
            paths.append(str(cam0 / "data" / (line + ".png")))
    else:
        for line in (cam0 / "data.csv").read_text().splitlines():
            if line.startswith('#'):
                continue
            t, name = line.strip().split(',')[:2]
            ts.append(float(t) / 1e9)
            paths.append(str(cam0 / "data" / name))
    return np.asarray(ts), paths


def _is_png(path) -> bool:
    return str(path).lower().endswith(".png")


def _cv2_read(path, flag_name: str):
    """A non-PNG file (JPEG frames of an endoscopy sequence) through
    OpenCV."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"{path} is not a PNG file and reading it needs OpenCV (cv2), "
            f"which is not installed; convert the sequence to PNG") from e
    img = cv2.imread(str(path), getattr(cv2, flag_name))
    if img is None:
        raise FileNotFoundError(path)
    return img


def read_gray(path, backend: str = "auto"):
    """Grey frame, (H, W) uint8."""
    if _is_png(path):
        return imageio.read_gray8(path, backend)
    return _cv2_read(path, "IMREAD_GRAYSCALE")


def read_depth(path, factor=5000.0, backend: str = "auto"):
    """TUM depth PNGs are uint16 with 5000 = 1 m (DepthMapFactor); -> (H, W)
    float32, raw / factor."""
    if _is_png(path):
        d16 = imageio.read_u16(path, backend)
    else:
        d16 = _cv2_read(path, "IMREAD_UNCHANGED")
    return d16.astype(np.float32) / factor


def iter_gray(paths, n_threads: int = 4, ahead: int = 8,
              backend: str = "auto"):
    """Prefetching iterator over grey frames (worker threads decode ahead
    of the tracking loop; the reference's C++ examples read each frame with
    a synchronous cv::imread). The prefetcher decodes PNG only; a sequence
    with other files (JPEG) is read frame by frame through `read_gray`."""
    if all(_is_png(p) for p in paths):
        return imageio.ImagePrefetcher(paths, n_threads=n_threads,
                                       ahead=ahead, backend=backend)
    return (read_gray(p, backend) for p in paths)
