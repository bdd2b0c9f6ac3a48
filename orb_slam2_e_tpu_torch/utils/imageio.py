"""PNG input and output for the dataset readers.

Port of the image-IO half of `orb_slam2_e_tpu/native/__init__.py`
(`read_gray8`, `read_u16`, `ImagePrefetcher`), with two decoders that give
the same bytes:

- `"libpng"`: `csrc/imageio.cpp`, this package's copy of the reference's
  source, built by g++ at first use into `build/` beside the package
  (`.gitignore` lists it) under a name hashed from the source and the
  flags, as `ops/geometry.py` builds `geometry.cpp`. Decoding runs outside
  the interpreter lock, and the prefetcher's workers are native threads.
- `"numpy"`: a decoder in numpy and the standard library's `zlib`, the
  plain twin. It reads non-interlaced 8- and 16-bit grey, grey + alpha,
  RGB and RGBA files with all five row filters, and refuses palette,
  sub-byte, interlaced and tRNS files (libpng reads the first three). The
  None, Sub and Up filters are array operations; Average and Paeth carry a
  dependency from pixel to pixel and run a Python loop along the row, so
  a file written with adaptive filters decodes slowly here. Colour goes to
  grey by libpng's own arithmetic for `png_set_rgb_to_gray_fixed(29900,
  58700)`, and the transforms run in libpng's order, so both decoders
  agree to the byte.

Which one runs is never silent. Every reader takes `backend`: `"libpng"`
raises with g++'s message when the build fails, `"numpy"` never builds,
and `"auto"` (the default) takes libpng when it builds and numpy
otherwise; `auto_backend()` reports which one and why, and the fallback
warns once. The reference swallows a failed build and falls back to cv2.

`write_png` writes 8- and 16-bit grey files and 8-bit RGB ones (filter None
or Up, which both decoders undo with array operations).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
import warnings
import zlib

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "imageio.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "build")
GXX = ["g++"]
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
GXX_LIBS = ["-lpng", "-lz", "-lpthread"]

BACKENDS = ("auto", "libpng", "numpy")
_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # colour type -> samples per pixel
# libpng's 15-bit coefficients for png_set_rgb_to_gray_fixed(29900, 58700)
_RC = 29900 * 32768 // 100000
_GC = 58700 * 32768 // 100000
_BC = 32768 - _RC - _GC


class _Lib:
    handle = None
    auto = None          # (backend, why) once "auto" has been resolved


def build() -> ctypes.CDLL:
    """Compile csrc/imageio.cpp (once per source hash) and load it. Raises
    RuntimeError with the compiler's message when it cannot."""
    if _Lib.handle is not None:
        return _Lib.handle
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(
            f.read() + " ".join(GXX_FLAGS + GXX_LIBS).encode()
        ).hexdigest()[:12]
    so_path = os.path.join(_BUILD_DIR, f"libimageio_{tag}.so")
    if not os.path.exists(so_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [*GXX, *GXX_FLAGS, _SRC, "-o", tmp, *GXX_LIBS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            err = proc.stderr if proc.returncode else None
        except OSError as e:              # no compiler at all
            err = str(e)
        if err is not None:
            os.remove(tmp)
            raise RuntimeError(f"{cmd[0]} failed on {_SRC}:\n"
                               f"{err}")
        os.replace(tmp, so_path)          # never a half-written library
    lib = ctypes.CDLL(so_path)
    u8p, ip = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
    lib.png_read_gray8.restype = ctypes.c_int
    lib.png_read_gray8.argtypes = [ctypes.c_char_p, u8p, ip, ip,
                                   ctypes.c_long]
    lib.png_read_u16.restype = ctypes.c_int
    lib.png_read_u16.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_uint16), ip, ip,
                                 ctypes.c_long]
    lib.prefetch_create.restype = ctypes.c_void_p
    lib.prefetch_create.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.prefetch_next.restype = ctypes.c_int
    lib.prefetch_next.argtypes = [ctypes.c_void_p, u8p, ip, ip,
                                  ctypes.c_long]
    lib.prefetch_destroy.restype = None
    lib.prefetch_destroy.argtypes = [ctypes.c_void_p]
    _Lib.handle = lib
    return lib


def auto_backend() -> tuple:
    """What `backend="auto"` takes, and why: ("libpng", "...") when
    csrc/imageio.cpp builds, else ("numpy", the compiler's message). The
    fallback warns once."""
    if _Lib.auto is None:
        try:
            build()
            _Lib.auto = ("libpng", "csrc/imageio.cpp built and loaded")
        except (RuntimeError, OSError) as e:
            _Lib.auto = ("numpy", f"libpng decoder unavailable: {e}")
            warnings.warn(f"PNG files are decoded by the numpy decoder: "
                          f"{_Lib.auto[1]}", RuntimeWarning, stacklevel=2)
    return _Lib.auto


def _resolve(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not "
                         f"{backend!r}")
    if backend == "auto":
        return auto_backend()[0]
    if backend == "libpng":
        build()
    return backend


# ---------------------------------------------------------------------------
# The numpy decoder
# ---------------------------------------------------------------------------

def _chunks(data: bytes, path):
    """Yield (type, payload) of each chunk, CRC checked."""
    if data[:8] != _SIGNATURE:
        raise IOError(f"not a PNG file: {path}")
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise IOError(f"truncated PNG file: {path}")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + n + 4
        if end > len(data):
            raise IOError(f"truncated PNG file: {path}")
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(kind + body) != crc:
            raise IOError(f"corrupt {kind.decode('latin1')} chunk: {path}")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end
    raise IOError(f"truncated PNG file (no IEND): {path}")


def _header(path) -> tuple:
    """(width, height) from the IHDR chunk, without decoding."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise IOError(f"not a PNG file: {path}")
    return struct.unpack(">II", head[16:24])


def _paeth_row(cur, prev, bpp):
    """Undo the Paeth filter on one row: a Python loop, pixel after pixel."""
    out = bytearray(cur)
    up = bytes(prev)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 255
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(cur, prev, bpp):
    out = bytearray(cur)
    up = bytes(prev)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + up[i]) >> 1)) & 255
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(raw: np.ndarray, bpp: int, path) -> np.ndarray:
    """(H, 1 + rowbytes) filtered scanlines -> (H, rowbytes) bytes."""
    kinds, rows = raw[:, 0], raw[:, 1:]
    if not kinds.any():
        return rows
    if kinds.max() > 4:
        raise IOError(f"unknown row filter {int(kinds.max())}: {path}")
    out = np.empty_like(rows)
    prev = np.zeros(rows.shape[1], np.uint8)
    for y, kind in enumerate(kinds.tolist()):
        cur = rows[y]
        if kind == 0:
            line = cur
        elif kind == 1:     # Sub: a prefix sum per byte lane, modulo 256
            line = np.cumsum(cur.reshape(-1, bpp), axis=0,
                             dtype=np.uint8).reshape(-1)
        elif kind == 2:     # Up
            line = cur + prev
        elif kind == 3:
            line = _average_row(cur, prev, bpp)
        else:
            line = _paeth_row(cur, prev, bpp)
        out[y] = line
        prev = out[y]
    return out


def _to_gray(px: np.ndarray, depth: int) -> np.ndarray:
    """(H, W, 3) samples -> (H, W) grey by libpng's rule: 15-bit integer
    coefficients, truncated at 8 bits and rounded at 16."""
    r, g, b = (px[..., i].astype(np.uint32) for i in range(3))
    y = _RC * r + _GC * g + _BC * b
    if depth == 16:
        y = y + 16384
    return (y >> 15).astype(np.uint16 if depth == 16 else np.uint8)


def decode_png(data: bytes, want16: bool, path="<bytes>") -> np.ndarray:
    """PNG file contents -> (H, W) uint8 grey, or uint16 with `want16`, as
    csrc/imageio.cpp's read_png gives them."""
    ihdr, idat, trns = None, [], False
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            ihdr = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tRNS":
            trns = True
    if ihdr is None or len(ihdr) != 13:
        raise IOError(f"no IHDR chunk: {path}")
    w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    if color not in _CHANNELS or depth not in (8, 16) or interlace or trns:
        raise IOError(
            f"the numpy decoder reads non-interlaced 8/16-bit grey, RGB and "
            f"RGBA without tRNS; {path} has colour type {color}, bit depth "
            f"{depth}, interlace {interlace}, tRNS {trns}")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    try:
        flat = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise IOError(f"corrupt image data ({e}): {path}") from None
    if len(flat) != h * (1 + w * bpp):
        raise IOError(f"image data holds {len(flat)} bytes, not "
                      f"{h * (1 + w * bpp)}: {path}")
    raw = np.frombuffer(flat, np.uint8).reshape(h, 1 + w * bpp)
    px = _unfilter(raw, bpp, path)
    if depth == 16:
        px = np.ascontiguousarray(px).view(">u2").astype(np.uint16)
    px = px.reshape(h, w, ch)
    # libpng's order: strip alpha, colour to grey at the file's depth, then
    # chop 16 -> 8 (high byte) or expand 8 -> 16 (v * 257)
    if ch in (2, 4):
        px = px[..., :ch - 1]
    gray = _to_gray(px, depth) if px.shape[-1] == 3 else px[..., 0]
    if want16 and depth == 8:
        gray = gray.astype(np.uint16) * 257
    elif not want16 and depth == 16:
        gray = (gray >> 8).astype(np.uint8)
    return np.ascontiguousarray(gray)


def _read_numpy(path, want16: bool) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), want16, path)


def _read_libpng(path, want16: bool) -> np.ndarray:
    lib = build()
    w, h = _header(path)
    out = np.empty((h, w), np.uint16 if want16 else np.uint8)
    cw, chh = ctypes.c_int(), ctypes.c_int()
    fn = lib.png_read_u16 if want16 else lib.png_read_gray8
    rc = fn(os.fsencode(path), out.ctypes.data_as(fn.argtypes[1]),
            ctypes.byref(cw), ctypes.byref(chh), out.size)
    if rc != 0:
        raise IOError(f"libpng could not decode ({rc}): {path}")
    return out


def _read(path, want16: bool, backend: str) -> np.ndarray:
    path = os.fspath(path)
    which = _resolve(backend)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return (_read_libpng if which == "libpng" else _read_numpy)(path, want16)


def read_gray8(path, backend: str = "auto") -> np.ndarray:
    """Decode a PNG to (H, W) uint8 grey."""
    return _read(path, False, backend)


def read_u16(path, backend: str = "auto") -> np.ndarray:
    """Decode a PNG (a TUM depth map) to (H, W) uint16."""
    return _read(path, True, backend)


# ---------------------------------------------------------------------------
# The writer
# ---------------------------------------------------------------------------

def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray, up: bool = True, level: int = 4) -> bytes:
    """(H, W) uint8 or uint16 grey, or (H, W, 3) uint8 RGB -> the bytes of a
    PNG. `up` filters every row against the one above (smaller files on
    smooth images), else no filter."""
    img = np.asarray(img)
    rgb = img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8
    if not rgb and (img.ndim != 2
                    or img.dtype not in (np.uint8, np.uint16)):
        raise ValueError(f"expected (H, W) uint8 or uint16, or (H, W, 3) "
                         f"uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(
        img.astype(">u2") if depth == 16 else img).view(np.uint8)
    rows = rows.reshape(h, -1)
    raw = np.empty((h, rows.shape[1] + 1), np.uint8)
    raw[:, 0] = 2 if up else 0
    raw[:, 1:] = rows
    if up:
        raw[1:, 1:] -= rows[:-1]          # uint8 arithmetic wraps modulo 256
    ihdr = struct.pack(">IIBBBBB", w, h, depth, 2 if rgb else 0, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path, img: np.ndarray, up: bool = True):
    """Write an (H, W) uint8 or uint16 grey image, or an (H, W, 3) uint8 RGB
    one, as a PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(img, up))


# ---------------------------------------------------------------------------
# The prefetcher
# ---------------------------------------------------------------------------

class ImagePrefetcher:
    """Ordered multi-threaded PNG prefetcher: an iterator over (H, W) arrays.

    Decoding runs `n_threads` workers up to `ahead` frames in front of the
    consumer. With the libpng backend they are the library's native
    threads; with the numpy backend a thread pool of this process (zlib
    releases the interpreter lock while it inflates)."""

    def __init__(self, paths, n_threads: int = 4, want16: bool = False,
                 ahead: int = 8, backend: str = "auto"):
        self.backend = _resolve(backend)
        self.paths = [os.fspath(p) for p in paths]
        self.want16 = want16
        self._i = 0
        self._h = self._pool = None
        if self.backend == "libpng":
            self._lib = build()
            blob = b"".join(os.fsencode(p) + b"\0" for p in self.paths)
            self._h = self._lib.prefetch_create(
                blob, len(self.paths), n_threads, int(want16), ahead)
        else:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max(1, n_threads))
            self._ahead = max(1, ahead)
            self._queue = []
            self._submitted = 0
            self._fill()

    def _fill(self):
        while (self._submitted < len(self.paths)
               and len(self._queue) < self._ahead):
            self._queue.append(self._pool.submit(
                _read_numpy, self.paths[self._submitted], self.want16))
            self._submitted += 1

    def __iter__(self):
        return self

    def __len__(self):
        return len(self.paths)

    def __next__(self) -> np.ndarray:
        if self._i >= len(self.paths):
            raise StopIteration
        path = self.paths[self._i]
        self._i += 1
        if self._pool is not None:
            fut = self._queue.pop(0)
            self._fill()
            return fut.result()
        if self._h is None:
            raise RuntimeError("the prefetcher is closed")
        try:
            w, h = _header(path)
        except OSError:
            w = h = 1                     # the decoder reports the failure
        out = np.empty((h, w), np.uint16 if self.want16 else np.uint8)
        cw, chh = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.prefetch_next(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(cw), ctypes.byref(chh), out.nbytes)
        if rc != 0:
            raise IOError(f"libpng could not decode ({rc}): {path}")
        return out

    def close(self):
        if self._h is not None:
            self._lib.prefetch_destroy(self._h)
            self._h = None
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
