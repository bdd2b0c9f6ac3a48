"""The port's host geometry, FEM functions and strain-augmented BA against
the reference (CPU): the same numpy inputs, made from a seed, go through
both packages."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from _torch_port import as_jax, deformed_problem, tnp, DEFORMED_CAM
from orb_slam2_e_tpu import native as jnative
from orb_slam2_e_tpu.models import deformable as JDEF
from orb_slam2_e_tpu.models.frame import Frame as JFrame
from orb_slam2_e_tpu.models.map_state import MapState as JMap
from orb_slam2_e_tpu.models.tracking import TrackConfig as JTrackConfig
from orb_slam2_e_tpu.ops import ba as jba
from orb_slam2_e_tpu.ops import fem as jfem
from orb_slam2_e_tpu.ops.camera import Camera as JCamera
from orb_slam2_e_tpu_torch.ops import ba as tba
from orb_slam2_e_tpu_torch.ops import fem as tfem
from orb_slam2_e_tpu_torch.ops import geometry
from orb_slam2_e_tpu_torch.ops.camera import Camera
from orb_slam2_e_tpu_torch.utils import convert

# mesh floats are f64 numpy results rounded to f32 once, in both packages
MESH_ATOL = 1e-6
# element stiffness: f32 products of ~1e5 (lambda) entries summed over 6 or
# 8 Gauss points; the port inverts J by adjugate, the reference by LU.
# Measured 2.8e-7 of the largest entry on both element types.
KE_RTOL_OF_MAX = 1e-5
# quantities linear or quadratic in K: held relative to |K| |a| (forces,
# matvec) or |K| |a|^2 (energy), the size of the terms that cancel: the
# material is nearly incompressible, so the result is far below them
# (measured: energy 1.6e-7, forces 8e-7, diagonal 2.2e-7 of that scale)
FEM_RTOL_OF_SCALE = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def grid_points(n=6, extent=1.0, z=5.0, bump=0.1):
    """tests/test_fem.py's grid, with a bump so no element is flat."""
    xs, ys = np.meshgrid(np.linspace(-extent, extent, n),
                         np.linspace(-extent, extent, n))
    zs = np.full_like(xs, z) + bump * np.exp(-(xs ** 2 + ys ** 2))
    pts = np.stack([xs.ravel(), ys.ravel(), zs.ravel()], 1).astype(np.float32)
    uv = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32) * 100 + 200
    return pts, uv


def _mesh_equal(jm, tm):
    for k in jm._fields:
        a, b = getattr(jm, k), getattr(tm, k)
        if k in ("el_type", "h"):
            assert a == b and type(a) is type(b), k
            continue
        a, b = np.asarray(a), tnp(b)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, atol=MESH_ATOL, rtol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


# ------------------------------------------------------------------ geometry

@pytest.mark.parametrize("case", ["random", "grid", "projected grid",
                                  "collinear", "two points"])
def test_delaunay_equals_reference_library(case):
    """Equal triangle arrays, row for row: the regular grid is all
    co-circular points, where another triangulator picks other diagonals."""
    rng = np.random.RandomState(0)
    if case == "random":
        uv = rng.rand(400, 2).astype(np.float32) * 480
    elif case == "grid":
        uv = grid_points(n=12)[1]
    elif case == "projected grid":
        uv = deformed_problem()["frame"]["uvr"][:81, :2]
    elif case == "collinear":
        uv = np.stack([np.arange(10.0), 2 * np.arange(10.0)], 1).astype(
            np.float32)
    else:
        uv = rng.rand(2, 2).astype(np.float32)
    want = jnative.delaunay(uv)
    assert want is not None              # the reference's library was built
    got = geometry.delaunay(uv)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if case in ("random", "grid", "projected grid"):
        assert len(got) > len(uv)


def test_knn_equals_reference_library():
    rng = np.random.RandomState(1)
    pts = rng.rand(500, 3).astype(np.float32) * 3
    q = rng.rand(200, 3).astype(np.float32) * 8 - 2.5   # some far outside
    for k, cell in ((1, 0.4), (4, 0.25)):
        want = jnative.knn(pts, q, k, cell=cell)
        got = geometry.knn(pts, q, k, cell=cell)
        np.testing.assert_array_equal(got, want)
    assert (got < 0).any() and (got >= 0).any()
    # nearest first among what the searched rings hold
    d = np.linalg.norm(q[:, None] - pts[np.maximum(got, 0)], axis=2)
    full = (got >= 0).all(1)
    assert full.any() and (np.diff(d[full], axis=1) >= 0).all()


def test_geometry_rejects_bad_input():
    with pytest.raises(ValueError):
        geometry.delaunay(np.zeros((5, 3), np.float32))
    with pytest.raises(ValueError):
        geometry.knn(np.zeros((5, 3), np.float32),
                     np.zeros((5, 2), np.float32), 1)
    with pytest.raises(ValueError):
        geometry.knn(np.zeros((5, 3), np.float32),
                     np.zeros((5, 3), np.float32), 0)


# --------------------------------------------------------------------- mesh

@pytest.mark.parametrize("el_type", [1, 2])
def test_build_mesh_equals_reference(el_type):
    pts, uv = grid_points()
    jm = jfem.build_mesh(pts, uv, el_type=el_type, max_nodes=1024,
                         max_elems=512)
    tm = tfem.build_mesh(pts, uv, el_type=el_type, max_nodes=1024,
                         max_elems=512, device="cpu")
    _mesh_equal(jm, tm)
    assert int(tm.elem_valid.sum()) > 10
    # and on an irregular cloud
    rng = np.random.RandomState(2)
    uv = (rng.rand(60, 2) * 300).astype(np.float32)
    pts = np.concatenate([uv / 100, 5 + rng.rand(60, 1)], 1).astype(
        np.float32)
    _mesh_equal(jfem.build_mesh(pts, uv, el_type=el_type),
                tfem.build_mesh(pts, uv, el_type=el_type, device="cpu"))


@pytest.mark.parametrize("case", ["too few points", "slivers only",
                                  "over node capacity",
                                  "over element capacity"])
def test_build_mesh_none_where_the_reference_gives_none(case):
    pts, uv = grid_points()
    kw = dict(el_type=2)
    if case == "too few points":
        pts, uv = pts[:7], uv[:7]
    elif case == "slivers only":
        uv = np.stack([np.arange(36.0), np.arange(36.0) * 1e-3], 1).astype(
            np.float32)
    elif case == "over node capacity":
        kw.update(max_nodes=128)
    else:
        kw.update(max_elems=16)
    assert jfem.build_mesh(pts, uv, **kw) is None
    assert tfem.build_mesh(pts, uv, device="cpu", **kw) is None


def test_fem_mesh_round_trip():
    pts, uv = grid_points()
    tm = tfem.build_mesh(pts, uv, el_type=2, device="cpu")
    back = convert.fem_mesh_from_numpy(convert.fem_mesh_to_numpy(tm), "cpu")
    for k in tm._fields:
        a, b = getattr(tm, k), getattr(back, k)
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b, k
    with pytest.raises(KeyError):
        convert.fem_mesh_from_numpy({"u0": np.zeros((4, 3))}, "cpu")


# ---------------------------------------------------------- FEM on the mesh

@pytest.fixture(scope="module", params=[1, 2])
def meshes(request):
    """The reference's mesh, carried across, with both packages' Ke."""
    pts, uv = grid_points()
    jm = jfem.build_mesh(pts, uv, el_type=request.param)
    arrays = {k: (v if k in ("el_type", "h") else np.asarray(v))
              for k, v in jm._asdict().items()}
    tm = convert.fem_mesh_from_numpy(arrays, "cpu")
    jke = jfem.element_stiffness_batch(jm)
    tke = tfem.element_stiffness_batch(tm)
    pts_def = pts.copy()
    pts_def[:, 2] += 0.2 * np.exp(-2 * (pts[:, 0] ** 2 + pts[:, 1] ** 2))
    pts_def[:, 0] += 0.05 * np.sin(3 * pts[:, 1])
    return jm, tm, jke, tke, pts, pts_def


def test_element_stiffness_batch(meshes):
    jm, tm, jke, tke, _, _ = meshes
    jke, tke = np.asarray(jke), tnp(tke)
    assert tke.shape == jke.shape == (jm.elements.shape[0], 24, 24)
    top = np.abs(jke).max()
    assert np.abs(tke - jke).max() <= KE_RTOL_OF_MAX * top
    np.testing.assert_allclose(tke, tke.transpose(0, 2, 1),
                               atol=KE_RTOL_OF_MAX * top)
    valid = tnp(tm.elem_valid)
    assert (tke[~valid] == 0).all()       # padded rows: 8 x node 0
    assert np.abs(tke[valid]).max() > 1.0
    if jm.el_type == 1:
        assert (tke[:, 18:] == 0).all() and (tke[:, :, 18:] == 0).all()


@pytest.mark.parametrize("el_type", [1, 2])
def test_degenerate_element_gives_zeros(el_type):
    """|det J| <= 1e-12 contributes 0, never NaN: an element collapsed into
    one point (J = 0 exactly), beside sound ones."""
    pts, uv = grid_points()
    tm = tfem.build_mesh(pts, uv, el_type=el_type, device="cpu")
    nodes = tm.elements[0][tm.elements[0] >= 0].long()
    u0 = tm.u0.clone()
    u0[nodes] = u0[nodes[0]].clone()
    ke = tfem.element_stiffness_batch(tm._replace(u0=u0))
    assert torch.isfinite(ke).all()
    assert (ke[0] == 0).all()
    untouched = ~torch.isin(tm.elements.long(), nodes).any(1) & tm.elem_valid
    assert int(untouched.sum()) > 10
    assert torch.equal(ke[untouched],
                       tfem.element_stiffness_batch(tm)[untouched])


def test_node_positions(meshes):
    jm, tm, _, _, pts, pts_def = meshes
    for p in (pts, pts_def):
        want = np.asarray(jfem.node_positions(jm, jnp.asarray(p)))
        got = tnp(tfem.node_positions(tm, _t(p)))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    n_surf = int(tm.n_nodes_active) // 2
    np.testing.assert_allclose(tnp(tfem.node_positions(tm, _t(pts)))[:n_surf],
                               tnp(tm.u0)[:n_surf], atol=1e-6)


def test_strain_energy_forces_matvec_diag(meshes):
    jm, tm, jke, tke, pts, pts_def = meshes
    top = float(np.abs(np.asarray(jke)).max())
    jn = jfem.node_positions(jm, jnp.asarray(pts_def))
    tn = tfem.node_positions(tm, _t(pts_def))
    a = float(np.abs(np.asarray(jn) - np.asarray(jm.u0)).max())
    n_act = float(jm.n_nodes_active)
    # energy: normalized by the node count, so is its scale
    ej, et = float(jfem.strain_energy(jm, jke, jn)), \
        float(tfem.strain_energy(tm, tke, tn))
    assert ej > 1e-2
    assert abs(et - ej) <= FEM_RTOL_OF_SCALE * top * a * a * 24 / n_act * \
        float(jm.elem_valid.sum())
    assert abs(et - ej) <= 1e-4 * ej      # and in fact far closer
    # a rigid translation: zero up to the cancellation
    shift = np.array([0.3, -0.2, 0.5], np.float32)
    ej0 = float(jfem.strain_energy(jm, jke, jfem.node_positions(
        jm, jnp.asarray(pts + shift))))
    et0 = float(tfem.strain_energy(tm, tke, tfem.node_positions(
        tm, _t(pts + shift))))
    assert et0 < 1e-2 and abs(et0 - ej0) <= FEM_RTOL_OF_SCALE * top
    # forces and the matrix-free product
    fj = np.asarray(jfem.nodal_forces(jm, jke, jn))
    ft = tnp(tfem.nodal_forces(tm, tke, tn))
    assert np.abs(ft - fj).max() <= FEM_RTOL_OF_SCALE * top * a * 24
    x = np.random.RandomState(3).randn(*jm.u0.shape).astype(np.float32) * .01
    mj = np.asarray(jfem.stiffness_matvec(jm, jke, jnp.asarray(x)))
    mt = tnp(tfem.stiffness_matvec(tm, tke, _t(x)))
    assert np.abs(mt - mj).max() <= FEM_RTOL_OF_SCALE * top * 0.04 * 24
    assert np.abs(mj).max() > 1.0
    dj = np.asarray(jfem.stiffness_diag(jm, jke))
    dt = tnp(tfem.stiffness_diag(tm, tke))
    assert np.abs(dt - dj).max() <= FEM_RTOL_OF_SCALE * np.abs(dj).max()
    # padded nodes receive exactly nothing
    n_surf, half = int(n_act) // 2, jm.u0.shape[0] // 2
    pad = np.r_[n_surf:half, half + n_surf:2 * half]
    assert (ft[pad] == 0).all() and (mt[pad] == 0).all() \
        and (dt[pad] == 0).all()


def test_solve_displacement(meshes):
    """The fixed 64-step Jacobi-CG against the reference's, on the
    reference's mesh: both layers of a block of nodes pinned at a
    displacement, the rest free (the mode-2 problem)."""
    jm, tm, jke, tke, pts, _ = meshes
    M = jm.u0.shape[0]
    half, n_surf = M // 2, int(jm.n_nodes_active) // 2
    fixed = np.ones((M,), bool)
    free_nodes = np.arange(n_surf // 2, n_surf)
    fixed[free_nodes] = False
    fixed[half + free_nodes] = False
    d_pin = np.zeros((M, 3), np.float32)
    d_pin[:n_surf // 2, 2] = 0.1
    d_pin[half:half + n_surf // 2, 2] = 0.1
    bj = -jfem.stiffness_matvec(jm, jke, jnp.asarray(d_pin))
    bt = -tfem.stiffness_matvec(tm, tke, _t(d_pin))
    aj = np.asarray(jfem.solve_displacement(jm, jke, bj, jnp.asarray(fixed)))
    at = tnp(tfem.solve_displacement(tm, tke, bt, _t(fixed)))
    assert (at[fixed] == 0).all()
    assert np.abs(aj).max() > 1e-2
    # 64 CG steps in f32 on a stiffness of condition ~1e4: the iterates of
    # the two packages drift apart by rounding; 2% of the largest
    # displacement (measured 1.0e-3 for prisms, 4.8e-6 for hexahedra)
    assert np.abs(at - aj).max() <= 2e-2 * np.abs(aj).max()


# ------------------------------------------------- ba_solve with extra cost

@pytest.mark.parametrize("el_type", [1, 2])
def test_ba_solve_with_extra_cost_matches_reference(el_type):
    """`ba_solve(extra_cost_fn=)` with the strain energy of the reference's
    mesh as the extra cost, on the gathered deformed problem. The strain
    term enters the accept/reject test alone, in every trial and in the
    trailing one of each phase; without it the result differs."""
    a = deformed_problem()
    nr = dict(pts_cap=128, obs_cap=1024, n_fixed_kfs=4)
    jcam = JCamera.create(**DEFORMED_CAM)
    tcam = Camera.create(**DEFORMED_CAM)
    jprob, _, _, row_ok = JDEF._gather_problem(
        jcam, JTrackConfig(n_levels=4), JDEF.NRConfig(**nr),
        as_jax(JMap, a["map"]), as_jax(JFrame, a["frame"]))
    tprob = convert.ba_problem_from_numpy(
        {k: np.asarray(v) for k, v in jprob._asdict().items()}, "cpu")
    n = a["n"]
    uv = a["frame"]["uvr"][:n, :2]
    jm = jfem.build_mesh(a["pts"], uv, el_type=el_type, max_nodes=1024,
                         max_elems=1024)
    tm = convert.fem_mesh_from_numpy(
        {k: (v if k in ("el_type", "h") else np.asarray(v))
         for k, v in jm._asdict().items()}, "cpu")
    jke = jfem.element_stiffness_batch(jm)
    tke = tfem.element_stiffness_batch(tm)

    def jextra(pts):
        return 5.0 * jfem.strain_energy(jm, jke, jfem.node_positions(
            jm, pts[:n]))

    def textra(pts):
        return 5.0 * tfem.strain_energy(tm, tke, tfem.node_positions(
            tm, pts[:n]))

    rj = jba.ba_solve(jcam, jprob, 10, 10, extra_cost_fn=jextra)
    rt = tba.ba_solve(tcam, tprob, 10, 10, extra_cost_fn=textra)
    # measured: poses to 4e-5, points to 4e-5 (the reference's own spread
    # under 1-ulp moves of its inputs: tests/test_torch_deformable.py)
    np.testing.assert_allclose(tnp(rt.cam_pose7), np.asarray(rj.cam_pose7),
                               atol=5e-4)
    np.testing.assert_allclose(tnp(rt.points), np.asarray(rj.points),
                               atol=5e-4)
    np.testing.assert_array_equal(tnp(rt.obs_inlier),
                                  np.asarray(rj.obs_inlier))
    plain = tba.ba_solve(tcam, tprob, 10, 10)
    assert float((plain.points - rt.points).abs().max()) > 1e-3
    assert int(rt.obs_inlier[:128].sum()) >= 0.8 * n
