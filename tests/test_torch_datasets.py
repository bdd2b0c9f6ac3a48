"""The port's dataset loaders against the reference's on the on-disk layouts
the examples read (TUM, TUM with associations, KITTI, EuRoC), and its image
readers against the reference's."""

import sys

import cv2
import numpy as np
import pytest

from orb_slam2_e_tpu.utils import datasets as ref
from orb_slam2_e_tpu_torch.utils import datasets as port

H, W = 24, 32


def _frames(n, seed, dtype=np.uint8):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, np.iinfo(dtype).max, (H, W)).astype(dtype)
            for _ in range(n)]


@pytest.fixture()
def tum_seq(tmp_path):
    seq = tmp_path / "tum"
    (seq / "rgb").mkdir(parents=True)
    (seq / "depth").mkdir()
    rgb, assoc = ["# color images", "# timestamp filename", ""], ["# a"]
    for k, (g, d) in enumerate(zip(_frames(5, 1), _frames(5, 2, np.uint16))):
        ts = f"{1305031102.175304 + k / 30.0:.6f}"
        cv2.imwrite(str(seq / "rgb" / f"{ts}.png"), g)
        cv2.imwrite(str(seq / "depth" / f"{ts}.png"), d)
        rgb.append(f"{ts} rgb/{ts}.png")
        assoc.append(f"{ts} rgb/{ts}.png {ts} depth/{ts}.png")
    (seq / "rgb.txt").write_text("\n".join(rgb) + "\n")
    (seq / "assoc.txt").write_text("\n".join(assoc) + "\n\n")
    return seq


@pytest.fixture()
def kitti_seq(tmp_path):
    seq = tmp_path / "kitti"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir()
    times = []
    for k, (l, r) in enumerate(zip(_frames(6, 3), _frames(6, 4))):
        cv2.imwrite(str(seq / "image_0" / f"{k:06d}.png"), l)
        cv2.imwrite(str(seq / "image_1" / f"{k:06d}.png"), r)
        times.append(f"{k / 10.0:.6e}")
    (seq / "times.txt").write_text("\n".join(times) + "\n")
    return seq


@pytest.fixture()
def euroc_seq(tmp_path):
    seq = tmp_path / "euroc"
    cam0 = seq / "mav0" / "cam0" / "data"
    cam0.mkdir(parents=True)
    csv, ts_lines = ["#timestamp [ns],filename"], []
    for k, f in enumerate(_frames(4, 5)):
        ns = 1403636579763555584 + int(round(k / 20.0 * 1e9))
        cv2.imwrite(str(cam0 / f"{ns}.png"), f)
        csv.append(f"{ns},{ns}.png")
        ts_lines.append(str(ns))
    (seq / "mav0" / "cam0" / "data.csv").write_text("\n".join(csv) + "\n")
    (seq / "timestamps.txt").write_text("\n".join(ts_lines) + "\n\n")
    return seq


def _same(got, want):
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype
    for g, w in zip(got[1:], want[1:]):
        assert g == w and all(isinstance(p, str) for p in g)


def test_load_tum_rgb(tum_seq):
    _same(port.load_tum_rgb(tum_seq), ref.load_tum_rgb(tum_seq))
    _same(port.load_tum_rgb(str(tum_seq)), ref.load_tum_rgb(str(tum_seq)))
    assert len(port.load_tum_rgb(tum_seq)[1]) == 5


def test_load_tum_associations(tum_seq):
    a = tum_seq / "assoc.txt"
    _same(port.load_tum_associations(tum_seq, a),
          ref.load_tum_associations(tum_seq, a))
    assert len(port.load_tum_associations(tum_seq, a)[2]) == 5


@pytest.mark.parametrize("stereo", [False, True])
def test_load_kitti(kitti_seq, stereo):
    _same(port.load_kitti(kitti_seq, stereo=stereo),
          ref.load_kitti(kitti_seq, stereo=stereo))
    assert len(port.load_kitti(kitti_seq, stereo=stereo)) == 2 + stereo


@pytest.mark.parametrize("with_ts_file", [False, True])
def test_load_euroc(euroc_seq, with_ts_file):
    ts_file = euroc_seq / "timestamps.txt" if with_ts_file else None
    _same(port.load_euroc(euroc_seq, ts_file),
          ref.load_euroc(euroc_seq, ts_file))
    assert len(port.load_euroc(euroc_seq, ts_file)[1]) == 4


@pytest.mark.parametrize("backend", ["auto", "libpng", "numpy"])
def test_read_gray_and_iter_gray(tum_seq, backend):
    _, paths = port.load_tum_rgb(tum_seq)
    want = [ref.read_gray(p) for p in paths]
    for p, w in zip(paths, want):
        g = port.read_gray(p, backend)
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    got = list(port.iter_gray(paths, n_threads=2, ahead=2, backend=backend))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got, ref.iter_gray(paths)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("factor", [1.0, 5000.0])
@pytest.mark.parametrize("backend", ["libpng", "numpy"])
def test_read_depth(tum_seq, factor, backend):
    _, _, depths = port.load_tum_associations(tum_seq, tum_seq / "assoc.txt")
    for p in depths:
        g, w = port.read_depth(p, factor, backend), ref.read_depth(p, factor)
        assert g.dtype == np.float32 and g.shape == (H, W)
        np.testing.assert_array_equal(g, w)
    assert port.read_depth(depths[0], 1.0).max() > 255      # 16 bits kept


def test_jpeg_goes_through_opencv(tmp_path, monkeypatch):
    frames = _frames(3, 6)
    paths = []
    for k, f in enumerate(frames):
        paths.append(str(tmp_path / f"{k}.jpg"))
        cv2.imwrite(paths[-1], f)
    for p in paths:
        np.testing.assert_array_equal(port.read_gray(p), ref.read_gray(p))
    got = list(port.iter_gray(paths))          # a generator, no prefetcher
    assert len(got) == 3
    with pytest.raises(FileNotFoundError):
        port.read_gray(tmp_path / "missing.jpg")
    # without OpenCV the error says what is missing and why it is needed
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        port.read_gray(paths[0])


def test_missing_png_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        port.read_gray(tmp_path / "missing.png")
    with pytest.raises(FileNotFoundError):
        port.read_depth(tmp_path / "missing.png")
