"""The port's proxy renderer (`orb_slam2_e_tpu_torch/tools/proxy_render.py`)
against the reference's generators (tools/make_proxy_*.py) on the CPU: the
stored source imagery, the ndarray.ptp fault, the texture tiling, the room,
and the raycaster over the room, the KITTI and EuRoC cameras and the
endoscopy surface. Tolerances: tests/_torch_proxy.py."""

import gzip
import os

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (thread settings)
from _torch_proxy import (DEPTH_ATOL, RENDER_MAX, RENDER_SHARE,
                          load_original)
from orb_slam2_e_tpu_torch.tools import make_proxy_dataset as tw_mpd
from orb_slam2_e_tpu_torch.tools import make_proxy_endo as tw_endo
from orb_slam2_e_tpu_torch.tools import make_proxy_euroc as tw_euroc
from orb_slam2_e_tpu_torch.tools import make_proxy_kitti as tw_kitti
from orb_slam2_e_tpu_torch.tools import proxy_render as pr

cv2 = pytest.importorskip("cv2")
matplotlib = pytest.importorskip("matplotlib")
MPL_DATA = os.path.join(matplotlib.get_data_path(), "sample_data")


@pytest.fixture(scope="module")
def ref():
    return load_original("make_proxy_dataset")


@pytest.fixture(scope="module")
def rooms(ref):
    """(reference room, port room) of seed 0, hopper only on both sides."""
    return ref.build_room(0), pr.build_room(0, which=("hopper",))


def assert_render_close(got, want, what):
    (img_t, dep_t), (img_r, dep_r) = got, want
    assert img_t.shape == img_r.shape and img_t.dtype == img_r.dtype == \
        np.uint8, what
    d = np.abs(img_t.astype(np.int16) - img_r.astype(np.int16))
    assert int(d.max()) <= RENDER_MAX, (what, int(d.max()))
    assert float((d > 0).mean()) <= RENDER_SHARE, (what, (d > 0).mean())
    assert dep_t.dtype == dep_r.dtype == np.float32
    np.testing.assert_allclose(dep_t, dep_r, rtol=0, atol=DEPTH_ATOL,
                               err_msg=what)
    assert np.array_equal(dep_t > 0, dep_r > 0), what


# ---------------------------------------------------------------------------
# The stored imagery and the texture faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["s1045.ima.gz", "topobathy.npz",
                                  "jacksboro_fault_dem.npz"])
def test_stored_files_equal_matplotlib_bytes(name):
    with open(os.path.join(MPL_DATA, name), "rb") as f:
        want = f.read()
    assert (pr.SAMPLE_DATA / name).read_bytes() == want


def test_stored_hopper_png_equals_the_decoded_jpeg():
    want = cv2.imread(os.path.join(MPL_DATA, "grace_hopper.jpg"),
                      cv2.IMREAD_GRAYSCALE)
    got = pr.load_real_textures(("hopper",))[0]
    assert want is not None and got.shape == want.shape == (600, 512)
    assert np.array_equal(got, want.astype(np.float32))
    assert (pr.SAMPLE_DATA / "README").exists()


def test_ptp_fault_of_the_reference(ref):
    """The reference calls ndarray.ptp(), which NumPy 2 removed, inside a
    try/except: it silently keeps the photograph alone. The twin loads the
    four, and its ("hopper",) is the reference's list."""
    texs_ref = ref._load_real_textures()
    if int(np.__version__.split(".")[0]) >= 2:
        assert len(texs_ref) == 1
    texs = pr.load_real_textures()
    assert len(texs) == 4
    assert all(t.dtype == np.float32 and t.min() >= 0 and t.max() <= 255
               for t in texs)
    for a, b in zip(pr.load_real_textures(("hopper",)), texs_ref):
        assert np.array_equal(a, b)
    # with ptp in numpy's name, the MRI slice is the reference's formula
    raw = gzip.decompress((pr.SAMPLE_DATA / "s1045.ima.gz").read_bytes())
    mri = np.frombuffer(raw, ">u2").reshape(256, 256).astype(np.float32)
    want = 255.0 * (mri - mri.min()) / max(float(np.ptp(mri)), 1.0)
    assert np.array_equal(texs[1], want)


def test_bathymetry_raster_is_smaller_than_a_tile(ref):
    """The second fault the first one hid: the reference's crop draw on the
    91 x 120 raster raises. The twin enlarges it (x2, bilinear, corners
    aligned), keeping its corners and range, and tiles from it."""
    raw = np.load(pr.SAMPLE_DATA / "topobathy.npz")["topo"]
    assert raw.shape == (91, 120)
    shade = pr._hillshade(raw.astype(np.float32))
    with pytest.raises(ValueError):
        ref._make_plane_texture(np.random.RandomState(0), [shade],
                                (160, 160))
    big = pr.load_real_textures(("topo",))[0]
    assert big.shape == (182, 240)
    for corner in ((0, 0), (0, -1), (-1, 0), (-1, -1)):
        assert big[corner] == pytest.approx(shade[corner], abs=1e-4)
    assert big.min() >= shade.min() - 1e-4 and big.max() <= shade.max() + 1e-4
    tex = pr.make_plane_texture(np.random.RandomState(0), [big], (320, 320))
    assert tex.shape == (320, 320) and np.isfinite(tex).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resize_area_equals_opencv(seed):
    rng = np.random.default_rng(seed)
    for k in range(12):
        ch, cw = rng.integers(160, 320, 2)
        src = (rng.random((ch, cw)) * 255).astype(np.float32)
        if k % 3 == 1:
            src = np.rot90(src[:, ::-1], k)       # strided views, as tiled
        want = cv2.resize(src, (160, 160), interpolation=cv2.INTER_AREA)
        assert np.array_equal(pr.resize_area(src, (160, 160)), want), (ch, cw)
    src = (rng.random((160, 237)) * 255).astype(np.float32)
    want = cv2.resize(src, (160, 160), interpolation=cv2.INTER_AREA)
    assert np.array_equal(pr.resize_area(src, (160, 160)), want)


def test_textures_and_room_equal_the_reference(ref, rooms):
    rng_r, rng_t = np.random.RandomState(3), np.random.RandomState(3)
    texs = ref._load_real_textures()
    a = ref._make_plane_texture(rng_r, texs, (330, 500))
    b = pr.make_plane_texture(rng_t, pr.load_real_textures(("hopper",)),
                              (330, 500))
    assert np.array_equal(a, b)
    assert rng_r.randint(1 << 30) == rng_t.randint(1 << 30)
    room_r, room_t = rooms
    assert len(room_r) == len(room_t) == 11
    for p, q in zip(room_r, room_t):
        for f in ("origin", "ex", "ey", "tex"):
            assert np.array_equal(getattr(p, f), getattr(q, f)), f


# ---------------------------------------------------------------------------
# The raycaster
# ---------------------------------------------------------------------------

SMALL, SMALL_K = (160, 120), tuple(v / 4 for v in (517.3, 516.5, 318.6,
                                                   255.3))


@pytest.mark.parametrize("kind,frames", [("xyz", (0, 37, 150)),
                                         ("desk", (5, 90, 240))])
def test_render_room_equals_the_reference(ref, rooms, kind, frames):
    room_r, room_t = rooms
    poses, _ = ref.trajectory(kind, max(frames) + 1)
    for k in frames:
        R, t = poses[k]
        want = ref.render(room_r, R, t, size=SMALL, intrinsics=SMALL_K)
        got = pr.render(room_t, R, t, size=SMALL, intrinsics=SMALL_K,
                        device="cpu")
        assert_render_close(got, want, f"{kind} frame {k}")
    # nothing but the room's planes is drawn: far walls fill every pixel
    assert (got[1] > 0).all()


def test_render_kitti_and_distorted_euroc_equal_the_reference():
    rk = load_original("make_proxy_kitti")
    ru = load_original("make_proxy_euroc")
    room_r, room_t = rk.build_room(1), pr.build_room(1, which=("hopper",))
    (R, t), = rk.forward_trajectory(31)[0][30:]
    size, intr = (160, 64), (87.5, 87.5, 80.0, 32.0)
    for shift in (0.0, tw_kitti.BASELINE):
        tt = t - np.array([shift, 0, 0])
        assert_render_close(
            pr.render(room_t, R, tt, size=size, intrinsics=intr,
                      device="cpu"),
            rk.render(room_r, R, tt, size=size, intrinsics=intr),
            f"kitti shift {shift}")
    assert np.array_equal(ru._inverse_distort_dirs(),
                          tw_euroc._inverse_distort_dirs())
    room_r, room_t = ru.build_room(2), pr.build_room(2, which=("hopper",))
    (R, t), = ru.trajectory("xyz", 8)[0][7:]
    dirs = ru._inverse_distort_dirs()
    # the reference sizes its buffers by the TUM defaults, not by `dirs`,
    # so its own generator fails on the 512x384 rays: pass the size
    with pytest.raises(ValueError):
        ru.render(room_r, R, t, dirs=dirs)
    want = ru.render(room_r, R, t, dirs=dirs, size=(tw_euroc.W, tw_euroc.H))
    got = pr.render(room_t, R, t, dirs=dirs, device="cpu")
    assert_render_close(got, want, "euroc raw left")
    # the distortion pulls the border in: the corners see wider angles
    assert abs(dirs[0, 0, 0]) > abs((0 - tw_euroc.CX) / tw_euroc.FX)


def test_render_endo_surface_equals_the_reference():
    re_ = load_original("make_proxy_endo")
    tex_r = re_._patch_textures(5)
    tex_t = tw_endo._patch_textures(5, ("hopper",))
    assert len(tex_t) == 117 and all(
        np.array_equal(a, b) for a, b in zip(tex_r, tex_t))
    poses, _ = re_._trajectory(31, "reloc")
    poses_t, _ = tw_endo._trajectory(31, "reloc")
    R, t = poses[30]
    assert np.array_equal(R, poses_t[30][0])
    ts = 30 / tw_endo.FPS
    pts = re_._surface_points(0.12, ts, 5)
    assert np.array_equal(pts, tw_endo._surface_points(0.12, ts, 5))
    size, intr = (120, 90), (105.0, 105.0, 60.0, 45.0)
    want = re_._mpd.render(re_._make_patches(pts, tex_r), R, t, near=0.05,
                           far=30.0, size=size, intrinsics=intr)
    got = pr.render(tw_endo._make_patches(pts, tex_t), R, t,
                    near=tw_endo.NEAR, far=tw_endo.FAR, size=size,
                    intrinsics=intr, device="cpu")
    assert_render_close(got, want, "endo amp 0.12")
    assert (got[1] > 0).mean() > 0.5          # mostly surface


def test_render_takes_the_first_of_equal_depths():
    """Two coplanar planes: the reference paints a plane only where it is
    strictly nearer, so the first keeps the pixel; so must the batches."""
    a = np.full((40, 40), 10.0, np.float32)
    b = np.full((40, 40), 200.0, np.float32)
    planes = [pr.Plane([-1, -1, 2], [2, 0, 0], [0, 2, 0], t)
              for t in (a, b) * 10]          # 20 planes, two batches
    img, dep = pr.render(planes, np.eye(3), np.zeros(3), size=(32, 24),
                         intrinsics=(20.0, 20.0, 16.0, 12.0), device="cpu")
    assert (img[dep > 0] == 10).all() and (dep[dep > 0] == 2.0).all()


@pytest.mark.cuda
def test_render_on_the_card_equals_the_cpu(rooms):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, room = rooms
    poses, _ = tw_mpd.trajectory("desk", 60)
    for R, t in poses[::20]:
        g = pr.render(room, R, t, device="cuda")
        c = pr.render(room, R, t, device="cpu")
        assert_render_close(g, c, "card vs CPU")
