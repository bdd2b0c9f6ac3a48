"""Public functions of the ported modules that the port lacked, each beside
the reference's on inputs from a seed: `lie.se3_to_mat4` / `se3_from_mat4`,
`Camera.baseline`, `camera.distort_normalized`, `camera.project(distort=)`,
`camera.project_stereo`, `matching.hamming_pairs`, `matching.mutual_filter`,
`bow.save_vocabulary`; and `synthetic.orbit_trajectory`'s jitter."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_port import tnp
from orb_slam2_e_tpu.ops import bow as jbow
from orb_slam2_e_tpu.ops import camera as jcam
from orb_slam2_e_tpu.ops import lie as jlie
from orb_slam2_e_tpu.ops import matching as jmatch
from orb_slam2_e_tpu.utils import synthetic as jsyn
from orb_slam2_e_tpu_torch.ops import bow, camera, lie, matching
from orb_slam2_e_tpu_torch.utils import synthetic

TUM1 = dict(fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
            k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628,
            k3=1.163314, bf=40.0, width=640, height=480)
KITTI = dict(fx=718.856, fy=718.856, cx=607.19, cy=185.21, bf=386.1448,
             width=1241, height=376)


@pytest.mark.parametrize("batch", [(), (4,), (2, 3)])
def test_mat4_roundtrip(batch):
    xi = np.random.RandomState(9).randn(*batch, 6).astype(np.float32)
    R, t = lie.se3_exp(torch.from_numpy(xi))
    T = lie.se3_to_mat4(R, t)
    assert T.shape == batch + (4, 4) and T.dtype == torch.float32
    jR, jt = jlie.se3_exp(jnp.asarray(xi))
    np.testing.assert_allclose(tnp(T), np.asarray(jlie.se3_to_mat4(jR, jt)),
                               atol=1e-6)
    np.testing.assert_array_equal(
        tnp(T[..., 3, :]), np.broadcast_to([0, 0, 0, 1], batch + (4,)))
    R2, t2 = lie.se3_from_mat4(T)
    assert torch.equal(R, R2) and torch.equal(t, t2)


def test_baseline():
    cam, jc = camera.Camera.create(**KITTI), jcam.Camera.create(**KITTI)
    assert float(cam.baseline) == float(jc.baseline)
    np.testing.assert_allclose(float(cam.baseline), 386.1448 / 718.856,
                               rtol=1e-6)


def test_distort_undistort_roundtrip():
    cam, jc = camera.Camera.create(**TUM1), jcam.Camera.create(**TUM1)
    xn = np.random.RandomState(1).uniform(-0.3, 0.3, (200, 2)).astype(
        np.float32)
    xd = camera.distort_normalized(cam, torch.from_numpy(xn))
    np.testing.assert_allclose(
        tnp(xd), np.asarray(jcam.distort_normalized(jc, jnp.asarray(xn))),
        atol=1e-6)
    assert np.abs(tnp(xd) - xn).max() > 1e-3          # it does distort
    np.testing.assert_allclose(tnp(camera.undistort_normalized(cam, xd)), xn,
                               atol=1e-5)


@pytest.mark.parametrize("distort", [False, True])
def test_project_distort(distort):
    cam, jc = camera.Camera.create(**TUM1), jcam.Camera.create(**TUM1)
    rng = np.random.RandomState(2)
    xc = np.concatenate([rng.uniform(-1, 1, (3, 50, 2)),
                         rng.uniform(2, 9, (3, 50, 1))], -1).astype(np.float32)
    xc[0, 0, 2] = 0.0                                 # the guarded depth
    uv, z = camera.project(cam, torch.from_numpy(xc), distort=distort)
    juv, jz = jcam.project(jc, jnp.asarray(xc), distort=distort)
    ok = np.abs(xc[..., 2]) > 1e-9
    np.testing.assert_allclose(tnp(uv)[ok], np.asarray(juv)[ok], rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_array_equal(tnp(z), np.asarray(jz))
    if not distort:                # the radial term overflows at depth 0
        assert torch.isfinite(uv).all()
    else:                          # and it is not the plain projection
        plain = tnp(camera.project(cam, torch.from_numpy(xc))[0])
        assert np.abs(tnp(uv) - plain)[ok].max() > 0.5


def test_stereo_ur():
    cam, jc = camera.Camera.create(**KITTI), jcam.Camera.create(**KITTI)
    xc = np.array([[1.0, 0.5, 10.0], [-2.0, 0.3, 4.0], [0.1, 0.1, 0.0]],
                  np.float32)
    uvr, z = camera.project_stereo(cam, torch.from_numpy(xc))
    juvr, jz = jcam.project_stereo(jc, jnp.asarray(xc))
    assert uvr.shape == (3, 3)
    np.testing.assert_allclose(tnp(uvr)[:2], np.asarray(juvr)[:2], rtol=1e-6)
    np.testing.assert_array_equal(tnp(z), np.asarray(jz))
    np.testing.assert_allclose(float(uvr[0, 0] - uvr[0, 2]),
                               386.1448 / 10.0, rtol=1e-5)


def test_hamming_pairs():
    rng = np.random.RandomState(4)
    a = rng.randint(0, 256, (64, 32)).astype(np.uint8)
    b = a.copy()
    b[::2] ^= rng.randint(0, 256, (32, 32)).astype(np.uint8)
    ba, bb = (matching.unpack_desc(torch.from_numpy(x)) for x in (a, b))
    d = matching.hamming_pairs(ba, bb)
    want = jmatch.hamming_pairs(jmatch.unpack_desc(jnp.asarray(a)),
                                jmatch.unpack_desc(jnp.asarray(b)))
    assert d.dtype == torch.int32
    np.testing.assert_array_equal(tnp(d), np.asarray(want))
    np.testing.assert_array_equal(tnp(d), tnp(torch.diagonal(
        matching.hamming_matrix(ba, bb))))
    assert (tnp(d)[1::2] == 0).all() and (tnp(d)[::2] > 0).all()


@pytest.mark.parametrize("ab,ba", [
    ([0, 1, 2], [0, 2, 2]),                  # tests/test_matching.py
    ([2, -1, 0, 5, 1], [2, 4, 0]),           # unmatched and out of range
    ([], [1, 2]),
])
def test_mutual_filter(ab, ba):
    keep = matching.mutual_filter(torch.tensor(ab, dtype=torch.int32),
                                  torch.tensor(ba, dtype=torch.int32))
    want = jmatch.mutual_filter(jnp.asarray(ab, jnp.int32),
                                jnp.asarray(ba, jnp.int32))
    assert keep.dtype == torch.bool
    np.testing.assert_array_equal(tnp(keep), np.asarray(want))
    if ab == [0, 1, 2]:
        assert keep.tolist() == [True, False, True]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.RandomState(11)
    return rng.randint(0, 256, (1500, 32)).astype(np.uint8)


def test_vocabulary_files_cross_packages(tmp_path, corpus):
    """A vocabulary saved by either package loads in the other."""
    docs = np.arange(len(corpus)) // 100
    tv = bow.train_vocabulary(corpus, k=4, L=2, iters=3, doc_ids=docs,
                              device="cpu")
    jv = jbow.train_vocabulary(corpus, k=4, L=2, iters=3, doc_ids=docs)
    # the trainers are the same numpy code: equal vocabularies
    np.testing.assert_array_equal(tnp(tv.node_bits), np.asarray(jv.node_bits))
    np.testing.assert_allclose(tnp(tv.idf), np.asarray(jv.idf), atol=1e-6)
    # the idf follows the documents given
    tv500 = bow.train_vocabulary(corpus, k=4, L=2, iters=3, device="cpu")
    assert not torch.equal(tv.idf, tv500.idf)

    bow.save_vocabulary(tmp_path / "port.npz", tv)
    jbow.save_vocabulary(tmp_path / "ref.npz", jv)
    from_port = jbow.load_vocabulary(tmp_path / "port.npz")
    from_ref = bow.load_vocabulary(tmp_path / "ref.npz", device="cpu")
    back = bow.load_vocabulary(tmp_path / "port.npz", device="cpu")
    for got in (from_ref, back):
        assert (got.k, got.L) == (4, 2)
        assert got.node_bits.dtype == torch.int8
        assert torch.equal(got.node_bits, tv.node_bits)       # exact
        np.testing.assert_allclose(tnp(got.idf), tnp(tv.idf), atol=1e-6)
    assert (from_port.k, from_port.L) == (4, 2)
    np.testing.assert_array_equal(np.asarray(from_port.node_bits),
                                  tnp(tv.node_bits))
    np.testing.assert_allclose(np.asarray(from_port.idf), tnp(tv.idf),
                               atol=1e-6)
    # and the words a loaded vocabulary assigns are the same
    valid = torch.ones(200, dtype=torch.bool)
    w_port, _ = bow.transform(from_ref, torch.from_numpy(corpus[:200]), valid)
    w_ref, _ = jbow.transform(from_port, jnp.asarray(corpus[:200]),
                              jnp.ones(200, bool))
    np.testing.assert_array_equal(tnp(w_port), np.asarray(w_ref))


def test_train_vocabulary_verbose(corpus, capsys):
    bow.train_vocabulary(corpus[:300], k=3, L=2, iters=2, verbose=True,
                         device="cpu")
    out = capsys.readouterr().out
    assert "vocab level 1/2" in out and "vocab level 2/2" in out


def test_orbit_trajectory_jitter():
    plain, c0 = synthetic.orbit_trajectory(6, 1.0, 0.03)
    again, _ = synthetic.orbit_trajectory(6, 1.0, 0.03, seed=5, jitter=0.0)
    for (R, t), (R2, t2) in zip(plain, again):
        np.testing.assert_array_equal(R, R2)
        np.testing.assert_array_equal(t, t2)
    shaken, c1 = synthetic.orbit_trajectory(6, 1.0, 0.03, seed=5, jitter=0.02)
    want, wc = jsyn.orbit_trajectory(6, 1.0, 0.03, seed=5, jitter=0.02)
    np.testing.assert_array_equal(c0, c1)             # centres stay
    np.testing.assert_array_equal(c1, wc)
    for (R, t), (Rw, tw) in zip(shaken, want):
        np.testing.assert_allclose(R, Rw, atol=1e-6)
        np.testing.assert_allclose(t, tw, atol=1e-6)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
    assert np.abs(shaken[3][0] - plain[3][0]).max() > 1e-3
