"""The port's PNG input and output: the numpy decoder, the libpng decoder,
`cv2.imread` and the reference's native reader must give equal arrays on
8-bit grey, RGB, RGBA and 16-bit grey files, written by OpenCV, by the
port's writer and by an encoder of this file that uses all five row
filters; the prefetcher keeps the order; the choice of decoder is never
silent."""

import struct
import warnings
import zlib

import cv2
import numpy as np
import pytest

from orb_slam2_e_tpu import native as ref_native
from orb_slam2_e_tpu_torch.utils import imageio

BACKENDS = ("libpng", "numpy")


def _smooth(rng, shape, dtype):
    """A smooth random image: neighbouring samples correlate, as in a
    photograph, so that the row filters have something to predict."""
    a = cv2.GaussianBlur(rng.rand(*shape), (0, 0), 2.5)
    a = (a - a.min()) / (a.max() - a.min())
    return (a * np.iinfo(dtype).max).astype(dtype)


def _images():
    rng = np.random.RandomState(7)
    return {
        "grey8": _smooth(rng, (37, 53), np.uint8),
        "rgb8": _smooth(rng, (41, 29, 3), np.uint8),
        "rgba8": _smooth(rng, (23, 31, 4), np.uint8),
        "grey16": _smooth(rng, (37, 53), np.uint16),
        "rgb16": _smooth(rng, (19, 27, 3), np.uint16),
    }


IMAGES = _images()


def _encode_all_filters(img: np.ndarray) -> bytes:
    """A PNG whose rows cycle through the five filter types (None, Sub, Up,
    Average, Paeth), written from the definition in the PNG specification.
    Channel order is the file's (RGB)."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    depth = 8 * img.dtype.itemsize
    color = {1: 0, 3: 2, 4: 6}[ch]
    rows = np.ascontiguousarray(
        img.astype(">u2") if depth == 16 else img).view(np.uint8).reshape(
        h, -1).astype(np.int32)
    bpp = ch * depth // 8
    raw = bytearray()
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        kind = y % 5
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        raw.append(kind)
        raw += ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


def _write(path, name, writer):
    """Write IMAGES[name] with `writer`; arrays are RGB(A), OpenCV wants
    BGR(A)."""
    img = IMAGES[name]
    if writer == "cv2":
        bgr = img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]]
        assert cv2.imwrite(str(path), np.ascontiguousarray(bgr))
    elif writer == "filters":
        path.write_bytes(_encode_all_filters(img))
    else:
        imageio.write_png(path, img, up=(writer == "port_up"))


def _cases():
    for name in IMAGES:
        for writer in ("cv2", "filters", "port_up", "port_none"):
            if writer.startswith("port") and name not in ("grey8", "grey16",
                                                          "rgb8"):
                continue              # the writer's formats
            yield name, writer


@pytest.mark.parametrize("name,writer", list(_cases()))
def test_decoders_agree(tmp_path, name, writer):
    path = tmp_path / f"{name}.png"
    _write(path, name, writer)
    img = IMAGES[name]
    is16 = img.dtype == np.uint16
    g8 = {b: imageio.read_gray8(path, b) for b in BACKENDS}
    g16 = {b: imageio.read_u16(path, b) for b in BACKENDS}
    for got, dt in ((g8, np.uint8), (g16, np.uint16)):
        for b in BACKENDS:
            assert got[b].dtype == dt and got[b].shape == img.shape[:2]
        np.testing.assert_array_equal(got["numpy"], got["libpng"])
    # the reference's native reader, the same libpng calls
    np.testing.assert_array_equal(g8["numpy"], ref_native.read_gray8(path))
    np.testing.assert_array_equal(g16["numpy"], ref_native.read_u16(path))
    # OpenCV: 8-bit grey of anything; 16-bit where the file holds 16 bits
    if not is16:
        np.testing.assert_array_equal(
            g8["numpy"], cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    else:
        np.testing.assert_array_equal(
            g16["numpy"], cv2.imread(
                str(path), cv2.IMREAD_GRAYSCALE | cv2.IMREAD_ANYDEPTH))
    # a grey file decodes to what was written
    if img.ndim == 2:
        np.testing.assert_array_equal((g16 if is16 else g8)["numpy"], img)
        if is16:
            np.testing.assert_array_equal(g8["numpy"], img >> 8)
        else:
            np.testing.assert_array_equal(g16["numpy"],
                                          img.astype(np.uint16) * 257)


def test_auto_reports_libpng():
    name, why = imageio.auto_backend()
    assert name == "libpng" and "built" in why
    with pytest.raises(ValueError, match="backend"):
        imageio.read_gray8("x.png", backend="pil")


@pytest.mark.parametrize("n_threads", [1, 4])
@pytest.mark.parametrize("want16", [False, True])
@pytest.mark.parametrize("backend", BACKENDS + ("auto",))
def test_prefetcher_keeps_order(tmp_path, n_threads, want16, backend):
    rng = np.random.RandomState(3)
    dt = np.uint16 if want16 else np.uint8
    frames = [_smooth(rng, (21 + k, 33), dt) for k in range(11)]
    paths = []
    for k, f in enumerate(frames):
        paths.append(tmp_path / f"{k:03d}.png")
        imageio.write_png(paths[-1], f)
    pf = imageio.ImagePrefetcher(paths, n_threads=n_threads, want16=want16,
                                 ahead=3, backend=backend)
    assert len(pf) == len(frames)
    got = list(pf)
    pf.close()
    assert len(got) == len(frames)
    for g, f in zip(got, frames):
        assert g.dtype == dt
        np.testing.assert_array_equal(g, f)
    ref = list(ref_native.ImagePrefetcher(paths, n_threads=n_threads,
                                          want16=want16, ahead=3))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.fixture()
def unbuilt(tmp_path, monkeypatch):
    """The module as on a machine where nothing is built yet."""
    monkeypatch.setattr(imageio, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(imageio._Lib, "handle", None)
    monkeypatch.setattr(imageio._Lib, "auto", None)


@pytest.mark.parametrize("gxx", [["/no/such/compiler"],
                                 ["g++", "--no-such-flag"]])
def test_failed_build_is_never_silent(tmp_path, monkeypatch, unbuilt, gxx):
    monkeypatch.setattr(imageio, "GXX", gxx)
    path = tmp_path / "a.png"
    imageio.write_png(path, IMAGES["grey8"])
    with pytest.raises(RuntimeError, match="failed on"):
        imageio.read_gray8(path, backend="libpng")
    with pytest.raises(RuntimeError, match="failed on"):
        imageio.ImagePrefetcher([path], backend="libpng")
    with pytest.warns(RuntimeWarning, match="numpy decoder"):
        name, why = imageio.auto_backend()
    assert name == "numpy" and "failed on" in why
    with warnings.catch_warnings():
        warnings.simplefilter("error")     # it warned once; not again
        np.testing.assert_array_equal(imageio.read_gray8(path),
                                      IMAGES["grey8"])
        got = list(imageio.ImagePrefetcher([path, path]))
    assert len(got) == 2


def test_build_from_source(unbuilt, tmp_path):
    """g++ builds csrc/imageio.cpp into an empty directory."""
    name, _ = imageio.auto_backend()
    assert name == "libpng"
    built = list((tmp_path / "build").glob("libimageio_*.so"))
    assert len(built) == 1 and not list((tmp_path / "build").glob("tmp*"))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("damage", ["truncated", "half", "not_png", "crc"])
def test_damaged_file_raises(tmp_path, backend, damage):
    data = imageio.encode_png(IMAGES["grey8"])
    if damage == "truncated":
        data = data[:len(data) - 40]
    elif damage == "half":
        data = data[:len(data) // 2]
    elif damage == "not_png":
        data = b"JFIF" + data[4:]
    else:
        i = len(data) // 2
        data = data[:i] + bytes([data[i] ^ 0x55]) + data[i + 1:]
    path = tmp_path / "bad.png"
    path.write_bytes(data)
    with pytest.raises(OSError):
        imageio.read_gray8(path, backend)
    with pytest.raises(OSError):
        list(imageio.ImagePrefetcher([path], backend=backend))
    with pytest.raises(FileNotFoundError):
        imageio.read_u16(tmp_path / "missing.png", backend)


@pytest.mark.parametrize("what", ["palette", "interlaced", "bits4"])
def test_numpy_decoder_names_what_it_refuses(tmp_path, what):
    """Files libpng reads and the twin does not: refused with the reason."""
    h, w = 8, 8
    depth, color, interlace = {"palette": (8, 3, 0), "interlaced": (8, 0, 1),
                               "bits4": (4, 0, 0)}[what]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                         0, interlace))
            + chunk(b"IDAT", zlib.compress(bytes(h * (1 + w))))
            + chunk(b"IEND", b""))
    path = tmp_path / "x.png"
    path.write_bytes(data)
    with pytest.raises(OSError, match="numpy decoder reads"):
        imageio.read_gray8(path, "numpy")


def test_writer_refuses_other_arrays(tmp_path):
    with pytest.raises(ValueError, match="expected"):
        imageio.write_png(tmp_path / "f.png", np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="expected"):
        imageio.write_png(tmp_path / "f.png", np.zeros((4, 4, 3), np.uint16))
