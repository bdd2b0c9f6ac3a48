"""The port's non-rigid pose optimization and the dual-optimization ladder
against the reference (CPU): `_gather_problem` exactly; the FEM-regularized
optimization for both element types, the mode-2 propagation and the whole
slice (a deformed map relocalized through `SlamSystem._relocalize`) within
the reference's own spread under 1-ulp moves of its inputs.

`JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_deformable.py`
prints that spread, which the bounds below come from; with the arguments
`jax ladder` or `jax workflow` (or `torch ...`) it runs part A or part B of
chip_smoke.py's deformable phase with that package on the CPU, at full
width: the gates of that phase come from the reference's run. `torch ladder
0 1 2 ...` repeats part A once per seed of the system's RANSAC draws."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from _torch_port import (DEFORMED_CAM, as_jax, deformed_problem,
                         deformed_system, deformed_system_arrays, tnp,
                         ulp_moved)
from test_torch_reloc import _pose_difference, _ref_pnp_draws
from orb_slam2_e_tpu.models import deformable as JDEF
from orb_slam2_e_tpu.models.frame import Frame as JFrame
from orb_slam2_e_tpu.models.map_state import MapState as JMap
from orb_slam2_e_tpu.models.tracking import TrackConfig as JTrackConfig
from orb_slam2_e_tpu.ops.camera import Camera as JCamera
from orb_slam2_e_tpu_torch.models import deformable as TDEF
from orb_slam2_e_tpu_torch.models import relocalization as TRL
from orb_slam2_e_tpu_torch.models.tracking import TrackConfig
from orb_slam2_e_tpu_torch.ops.camera import Camera
from orb_slam2_e_tpu_torch.utils import convert

NR = dict(pts_cap=128, obs_cap=1024, n_fixed_kfs=4, mesh_nodes=1024,
          mesh_elems=1024)
# The strain energy enters only the accept/reject comparison of each LM
# trial, so an f32 difference can flip a step, and 1-ulp moves of the
# projections can flip a diagonal of the mesh. The reference's own answers
# on `deformed_problem()` under 1-ulp moves of lm_xyz and uvr (12 seeds),
# and where the port stands from the unmoved reference:
#   el_type          rotation (rad)  centre (m)  farthest point (m)  n_good
#   1  ref. spread   9.4e-8          6.5e-7      2.6e-5              81..81
#      port          0               1.1e-7      1.0e-6              81
#   2  ref. spread   5.6e-5          2.8e-4      3.5e-4              81..81
#      port          7.4e-6          3.7e-5      4.0e-5              81
# Bounds: about 4x the larger spread; n_good does not move, so it is held
# equal.
NR_ROT_MAX = 2e-4           # rad
NR_CENTRE_MAX = 1e-3        # metres
NR_POINTS_MAX = 1.5e-3      # metres, the farthest moved landmark
# mode 2: 64 CG steps from the moved tracked points; the untracked points'
# displacement is compared relative to the largest one. Measured 3.9e-6
# (all 40 untracked points) and 1.2e-6 (the 12 nearest); the bound is the
# drift the same CG shows on another mesh (tests/test_torch_fem.py, 1e-3)
MODE2_RTOL = 1e-3


def _both(a):
    jcam, tcam = JCamera.create(**DEFORMED_CAM), Camera.create(**DEFORMED_CAM)
    return (jcam, as_jax(JMap, a["map"]), as_jax(JFrame, a["frame"]),
            tcam, convert.map_state_from_numpy(a["map"], "cpu"),
            convert.frame_from_numpy(a["frame"], "cpu"))


# ----------------------------------------------------------------- gathering

@pytest.mark.parametrize("case", ["all bound", "holes", "one keyframe"])
def test_gather_problem_exact(case):
    """BAProblem, rows, lm_ids and row_ok, field by field. `holes`: row 0
    unbound (the padding aliases it), bound rows that are not valid, and a
    keyframe that has lost some observations; `one keyframe`: the votes of
    all but one keyframe tie at 0."""
    a = deformed_problem()
    n = a["n"]
    if case == "holes":
        pid = a["frame"]["point_ids"].copy()
        pid[[0, 5, 17]] = -1
        valid = a["frame"]["valid"].copy()
        valid[[3, 40]] = False
        a["frame"] = dict(a["frame"], point_ids=pid, valid=valid)
        a["map"]["kf_kp_point"][1, 10:30] = -1
        a["map"]["kf_kp_valid"][0, 60:70] = False
    elif case == "one keyframe":
        a["map"]["kf_valid"][1] = False
    jcam, jm, jf, tcam, tm, tf = _both(a)
    jp, *jrest = JDEF._gather_problem(jcam, JTrackConfig(n_levels=4),
                                      JDEF.NRConfig(**NR), jm, jf)
    tp, *trest = TDEF._gather_problem(tcam, TrackConfig(n_levels=4),
                                      TDEF.NRConfig(**NR), tm, tf)
    for k in jp._fields:
        want, got = np.asarray(getattr(jp, k)), tnp(getattr(tp, k))
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for name, want, got in zip(("rows", "lm_ids", "row_ok"), jrest, trest):
        np.testing.assert_array_equal(tnp(got), np.asarray(want),
                                      err_msg=name)
    n_rows = int(trest[2].sum())
    assert n_rows == {"holes": n - 5}.get(case, n)
    assert int(tp.obs_valid.sum()) > n_rows


# ------------------------------------------------- the non-rigid optimization

def _nr_difference(a, fr_t, st_t, fr_j, st_j):
    """(rotation rad, centre m, farthest moved landmark m) between two
    results of pose_optimization_nr."""
    n = a["n"]
    rot, centre = _pose_difference(np.asarray(fr_t.pose7),
                                   np.asarray(fr_j.pose7))
    pts = np.linalg.norm(np.asarray(st_t.lm_xyz)[:n]
                         - np.asarray(st_j.lm_xyz)[:n], axis=1).max()
    return rot, centre, float(pts)


def tf_np(nt):
    """A port NamedTuple as numpy fields (for `_nr_difference`)."""
    return type(nt)(*[tnp(v) for v in nt])


@pytest.mark.parametrize("el_type", [1, 2])
def test_pose_optimization_nr_matches_reference(el_type):
    a = deformed_problem()
    n = a["n"]
    jcam, jm, jf, tcam, tm, tf = _both(a)
    fr_j, st_j, n_j, ran_j = JDEF.pose_optimization_nr(
        jcam, JTrackConfig(n_levels=4),
        JDEF.NRConfig(el_type=el_type, **NR), jm, jf)
    fr_t, st_t, n_t, ran_t = TDEF.pose_optimization_nr(
        tcam, TrackConfig(n_levels=4),
        TDEF.NRConfig(el_type=el_type, **NR), tm, tf)
    assert ran_j and ran_t
    assert isinstance(n_t, int) and n_t == int(n_j)
    assert n_t >= 0.8 * n
    rot, centre, pts = _nr_difference(a, tf_np(fr_t), tf_np(st_t), fr_j, st_j)
    assert rot < NR_ROT_MAX and centre < NR_CENTRE_MAX, (rot, centre)
    assert pts < NR_POINTS_MAX, pts
    # the map deformed: landmarks moved, toward what the frame sees
    moved = np.linalg.norm(tnp(st_t.lm_xyz)[:n] - a["pts"], axis=1)
    assert moved.mean() > 1e-3
    np.testing.assert_array_equal(tnp(st_t.lm_rigid),
                                  np.asarray(st_j.lm_rigid))
    assert (tnp(st_t.lm_rigid)[:n] == 2).all()
    # outlier associations are unbound, the others kept
    np.testing.assert_array_equal(tnp(fr_t.point_ids),
                                  np.asarray(fr_j.point_ids))
    assert int((fr_t.point_ids >= 0).sum()) == n_t
    # the inputs are not written
    np.testing.assert_array_equal(tnp(tm.lm_xyz), a["map"]["lm_xyz"])
    np.testing.assert_array_equal(tnp(tf.point_ids),
                                  a["frame"]["point_ids"])


@pytest.mark.parametrize("case", ["too few points", "mesh over capacity"])
def test_pose_optimization_nr_gives_up_as_the_reference(case):
    a = deformed_problem()
    nr = dict(NR)
    if case == "too few points":
        pid = a["frame"]["point_ids"].copy()
        pid[11:] = -1
        a["frame"] = dict(a["frame"], point_ids=pid)
    else:
        nr.update(mesh_nodes=64)
    jcam, jm, jf, tcam, tm, tf = _both(a)
    out_j = JDEF.pose_optimization_nr(jcam, JTrackConfig(n_levels=4),
                                      JDEF.NRConfig(**nr), jm, jf,
                                      return_prop=True)
    out_t = TDEF.pose_optimization_nr(tcam, TrackConfig(n_levels=4),
                                      TDEF.NRConfig(**nr), tm, tf,
                                      return_prop=True)
    assert out_t[2:] == out_j[2:] == (0, False, None)
    assert out_t[0] is tf and out_t[1] is tm


def _untracked_odd(a):
    """tests/test_deformable.py::test_mode2_propagates_to_untracked: the
    frame loses its bindings to the odd landmarks."""
    un = np.arange(1, a["n"], 2)
    pid, valid = a["frame"]["point_ids"].copy(), a["frame"]["valid"].copy()
    pid[un] = -1
    valid[un] = False
    a["frame"] = dict(a["frame"], point_ids=pid, valid=valid)
    return un


@pytest.mark.parametrize("mode2_cap", [256, 12])
def test_propagate_untracked_matches_reference(mode2_cap):
    """Mode 2 on the reference's optimized points, carried across: the
    same untracked landmarks are chosen (with `mode2_cap` 12, by the
    nearest-neighbour search), flagged and moved alike."""
    a = deformed_problem()
    un = _untracked_odd(a)
    n = a["n"]
    jcam, jm, jf, tcam, tm, tf = _both(a)
    jnr = JDEF.NRConfig(mode2=True, mode2_cap=mode2_cap, **NR)
    tnr = TDEF.NRConfig(mode2=True, mode2_cap=mode2_cap, **NR)
    fr_j, st_j, _, ran, prop_j = JDEF.pose_optimization_nr(
        jcam, JTrackConfig(n_levels=4), jnr, jm, jf, return_prop=True)
    assert ran and prop_j is not None
    out_j = prop_j()
    # the reference's inputs of the propagation, carried across
    _, rows, lm_ids, row_ok = JDEF._gather_problem(
        jcam, JTrackConfig(n_levels=4), jnr, jm, jf)
    old = np.asarray(jm.lm_xyz)[np.asarray(lm_ids)]
    new = np.asarray(st_j.lm_xyz)[np.asarray(lm_ids)]
    st_t = convert.map_state_from_numpy(
        {k: np.asarray(v) for k, v in st_j._asdict().items()}, "cpu")
    fr_t = convert.frame_from_numpy(
        {k: np.asarray(v) for k, v in fr_j._asdict().items()}, "cpu")
    out_t = TDEF.propagate_untracked(
        tcam, tnr, st_t, fr_t, torch.from_numpy(np.array(lm_ids)),
        torch.from_numpy(np.array(row_ok)), old, new)
    np.testing.assert_array_equal(tnp(out_t.lm_rigid),
                                  np.asarray(out_j.lm_rigid))
    n_flagged = int((tnp(out_t.lm_rigid)[un] == 2).sum())
    assert n_flagged == min(mode2_cap, len(un))
    d_j = np.asarray(out_j.lm_xyz)[:n] - np.asarray(st_j.lm_xyz)[:n]
    d_t = tnp(out_t.lm_xyz)[:n] - tnp(st_t.lm_xyz)[:n]
    top = np.abs(d_j).max()
    assert top > 1e-4
    assert np.abs(d_t - d_j).max() <= MODE2_RTOL * top
    assert (d_t[::2] == 0).all()          # tracked points stay as optimized


def test_mode2_through_pose_optimization_nr():
    """`mode2=True` without `return_prop` propagates at once; the
    untracked landmarks follow the deformation of the tracked surface."""
    a = deformed_problem()
    un = _untracked_odd(a)
    _, _, _, tcam, tm, tf = _both(a)
    _, st, _, ran = TDEF.pose_optimization_nr(
        tcam, TrackConfig(n_levels=4),
        TDEF.NRConfig(mode2=True, mode2_cap=256, **NR), tm, tf)
    assert ran
    dz = tnp(st.lm_xyz)[un, 2] - a["pts"][un, 2]
    dz_true = a["pts_def"][un, 2] - a["pts"][un, 2]
    assert np.corrcoef(dz, dz_true)[0, 1] > 0.3
    assert (tnp(st.lm_rigid)[un] == 2).all()


@pytest.mark.parametrize("rigid", [True, False])
def test_set_rigidity_flags(rigid):
    a = deformed_problem()
    pid = a["frame"]["point_ids"].copy()
    pid[[0, 7]] = -1
    a["frame"] = dict(a["frame"], point_ids=pid)
    _, jm, jf, _, tm, tf = _both(a)
    want = np.asarray(JDEF.set_rigidity_flags(jm, jf, rigid).lm_rigid)
    got = tnp(TDEF.set_rigidity_flags(tm, tf, rigid).lm_rigid)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int8 and got[0] == 0 and got[1] == (1 if rigid
                                                               else 2)


# ------------------------------------------------------- the slice as a whole

# tests/test_reloc_kpi.py::build_deformed_system's field (accepted at S1 by
# the non-rigid branch alone), and the harsher one of its
# test_nr_rescue_decision_table, on which the non-rigid branch wins S1 below
# the acceptance bar, so that S2 and S3 search the deformed working map,
# mode 2 included, and the attempt is refused
SLICE_CASES = {
    "accepted at S1": dict(),
    "three stages": dict(n_grid=11, defmag=0.65, tang=0.5, n_features=150),
}
# The reference's own stats rows under 1-ulp moves of lm_xyz and uvr (6
# seeds): "accepted at S1" does not move (nGoodR 15, nGoodNR 63); "three
# stages" reads nGoodR 9 and nGoodNR 28..29 at S1, then 27..29 for both
# branches at S2 and S3 (spread 2), and is refused every time. The port
# reads 15 / 63, and 9 / 29 then 29s.
SLICE_GOOD_SLACK = 2


def _with_reference_draws(monkeypatch, key):
    """Make the port's candidate evaluation draw the reference's RANSAC
    sets: `key` is the key the reference's `_relocalize` passes on, split
    once per candidate in scan order."""
    plain = TRL.relocalize_candidates

    def with_draws(gen, cam, cfg, state, frame, cand, cand_ok):
        draws, k = [], key
        for kf in cand.tolist():
            k, sub = jax.random.split(k)
            _, pair, _, _ = TRL.candidate_matches(state, frame, kf)
            enough = bool(pair.sum() >= TRL.MIN_BOW_MATCHES)
            draws.append(_ref_pnp_draws(sub, jnp.asarray(tnp(pair) & enough),
                                        TRL.N_HYP))
        return plain(gen, cam, cfg, state, frame, cand, cand_ok, sets=draws)

    monkeypatch.setattr(TRL, "relocalize_candidates", with_draws)


def _stats_row(path):
    header, row = (r.split("\t") for r in path.read_text().splitlines()[:2])
    return dict(zip(header, row))


@pytest.mark.parametrize("case", list(SLICE_CASES))
def test_deformed_map_relocalizes_as_the_reference(case, tmp_path,
                                                   monkeypatch):
    a = deformed_system_arrays(**SLICE_CASES[case])
    n = a["n"]
    sj, fj = deformed_system("jax", a, tmp_path / "j.txt")
    st, ft = deformed_system("torch", a, tmp_path / "t.txt")
    _with_reference_draws(monkeypatch, jax.random.split(sj.key)[1])
    out_j, ok_j = sj._relocalize(fj)
    out_t, ok_t = st._relocalize(ft)
    vj, vt = _stats_row(tmp_path / "j.txt"), _stats_row(tmp_path / "t.txt")
    assert ok_t == ok_j == (case == "accepted at S1")
    for col in ("KF_candidates", "Inliers_PnP_R", "Stage", "Accepted",
                "nGoodR_S1"):
        assert vt[col] == vj[col], (col, vt, vj)
    stages = [s for s in (1, 2, 3) if vj[f"nGoodR_S{s}"] != ""]
    assert stages == [s for s in (1, 2, 3) if vt[f"nGoodR_S{s}"] != ""]
    assert len(stages) == (1 if ok_j else 3)
    for s in stages:
        # from S2 on the rigid branch works on the map the non-rigid one
        # deformed, so its count moves with that branch's
        for col in (f"nGoodR_S{s}", f"nGoodNR_S{s}"):
            assert abs(int(vt[col]) - int(vj[col])) <= SLICE_GOOD_SLACK, \
                (col, vt, vj)
        assert float(vt[f"timeNR_S{s}"]) > 0
    assert int(vt["nGoodR_S1"]) < 50 and int(vt["nGoodNR_S1"]) >= 10
    np.testing.assert_array_equal(tnp(st.map.lm_rigid),
                                  np.asarray(sj.map.lm_rigid))
    if ok_j:
        assert int((st.map.lm_rigid[:n] == 2).sum()) > n // 2
        rot, centre = _pose_difference(tnp(out_t.pose7), out_j.pose7)
        assert rot < NR_ROT_MAX and centre < NR_CENTRE_MAX, (rot, centre)
        d = np.linalg.norm(tnp(st.map.lm_xyz) - np.asarray(sj.map.lm_xyz),
                           axis=1).max()
        assert d < NR_POINTS_MAX, d
        assert st.stats["relocs"] == sj.stats["relocs"] == 1
    else:
        # a refused attempt leaves the map as it was, bit for bit
        for k, v in st.map._asdict().items():
            np.testing.assert_array_equal(tnp(v), a["map"][k], err_msg=k)
        assert out_t is ft
    assert (st.kpi.tp, st.kpi.fp, st.kpi.fn) == (sj.kpi.tp, sj.kpi.fp,
                                                 sj.kpi.fn)


def test_rigid_only_system_fails_where_the_deformable_one_relocalizes(
        tmp_path):
    """The same deformed map with `deformable=False`: the rigid ladder
    alone stays under the bar, the non-rigid columns read -1, the map is
    untouched."""
    a = deformed_system_arrays()
    st, ft = deformed_system("torch", a, tmp_path / "t.txt",
                             deformable=False)
    _, ok = st._relocalize(ft)
    v = _stats_row(tmp_path / "t.txt")
    assert not ok and v["Accepted"] == "0" and v["Stage"] == "3"
    assert all(v[f"nGoodNR_S{s}"] == "-1" for s in (1, 2, 3))
    assert all(int(v[f"nGoodR_S{s}"]) < 50 for s in (1, 2, 3))
    for k, val in st.map._asdict().items():
        np.testing.assert_array_equal(tnp(val), a["map"][k], err_msg=k)


# ---------------------------------------------------------------------------
# main: the reference's own spread under 1-ulp moves of its inputs
# ---------------------------------------------------------------------------

def _print_nr_spread(n_seeds=12):
    a = deformed_problem()
    jcam, jm, jf, tcam, tm, tf = _both(a)
    for el_type in (1, 2):
        jnr = JDEF.NRConfig(el_type=el_type, **NR)

        def run(state, frame):
            fr, st, n_good, _ = JDEF.pose_optimization_nr(
                jcam, JTrackConfig(n_levels=4), jnr, state, frame)
            return fr, st, int(n_good)

        fr0, st0, n0 = run(jm, jf)
        worst, counts = np.zeros(3), []
        for seed in range(n_seeds):
            rng = np.random.RandomState(300 + seed)
            fr1, st1, n1 = run(
                jm._replace(lm_xyz=jnp.asarray(ulp_moved(jm.lm_xyz, rng))),
                jf._replace(uvr=jnp.asarray(ulp_moved(jf.uvr, rng))))
            worst = np.maximum(worst, _nr_difference(a, fr1, st1, fr0, st0))
            counts.append(n1)
        fr_t, st_t, n_t, _ = TDEF.pose_optimization_nr(
            tcam, TrackConfig(n_levels=4),
            TDEF.NRConfig(el_type=el_type, **NR), tm, tf)
        port = _nr_difference(a, tf_np(fr_t), tf_np(st_t), fr0, st0)
        print(f"pose_optimization_nr el_type {el_type}: reference 1-ulp "
              "spread (rad, m, m) %.3g %.3g %.3g, n_good %d..%d (base %d); "
              "port vs reference %.3g %.3g %.3g, n_good %d"
              % (*worst, min(counts), max(counts), n0, *port, n_t))


def _print_slice_spread(n_seeds=6):
    import pathlib
    import tempfile
    for case, field in SLICE_CASES.items():
        a = deformed_system_arrays(**field)
        rows = []
        with tempfile.TemporaryDirectory() as d:
            for seed in range(n_seeds + 1):
                b = dict(a)
                if seed:
                    rng = np.random.RandomState(400 + seed)
                    b["map"] = dict(a["map"], lm_xyz=ulp_moved(
                        a["map"]["lm_xyz"], rng))
                    b["frame"] = dict(a["frame"], uvr=ulp_moved(
                        a["frame"]["uvr"], rng))
                path = pathlib.Path(d) / f"{seed}.txt"
                sj, fj = deformed_system("jax", b, path)
                _, ok = sj._relocalize(fj)
                v = _stats_row(path)
                rows.append([int(ok)] + [
                    int(v[f"nGood{b_}_S{s}"] or -9) for s in (1, 2, 3)
                    for b_ in ("R", "NR")])
        rows = np.array(rows)
        print(f"slice '{case}': reference, unmoved then {n_seeds} 1-ulp "
              "seeds; columns ok, then nGoodR / nGoodNR of S1, S2, S3 (-9: "
              f"stage not run)\n{rows}\nspread per column "
              f"{rows.max(0) - rows.min(0)}")


def run_chip_phase(package: str, part: str, seeds=(0,)):
    """chip_smoke.py's deformable phase on the CPU with either package;
    part A once per seed of the RANSAC draws."""
    import pathlib
    import tempfile
    import chip_smoke as cs
    import _torch_port as tp
    system, _, _, _, _, Camera = tp._package(package)
    if package == "jax":
        from orb_slam2_e_tpu.utils.trajectory import ate_rmse
        kw = {}
    else:
        from orb_slam2_e_tpu_torch.utils.trajectory import ate_rmse
        kw = dict(device="cpu")

    def feed(s, frames, lo):
        cen = []
        for k, (img, depth) in enumerate(frames):
            pose = s.track_rgbd(img, depth, (lo + k) / 30.0)
            cen.append(None if pose is None else
                       -np.asarray(pose[0], np.float64).T
                       @ np.asarray(pose[1], np.float64))
        ok = [i for i, c in enumerate(cen) if c is not None]
        ate = ate_rmse(np.stack([cen[i] for i in ok]),
                       centers[lo:lo + len(frames)][ok].astype(np.float64),
                       False)
        return len(ok), round(float(ate), 4)

    tmp = pathlib.Path(tempfile.mkdtemp())
    if part == "ladder":
        tp.DEFORMED_CAM.update(fx=cs.FX, fy=cs.FX, cx=cs.WIDTH / 2,
                               cy=cs.HEIGHT / 2, width=cs.WIDTH,
                               height=cs.HEIGHT)
        dflt = system.SystemConfig()
        for el_type, grid in cs.DEFORM_GRIDS.items():
            a = deformed_system_arrays(
                n_features=dflt.n_features, n_levels=dflt.n_levels,
                max_keyframes=dflt.max_keyframes, max_points=dflt.max_points,
                fx=cs.FX, cx=cs.WIDTH / 2, cy=cs.HEIGHT / 2, **grid,
                **cs.DEFORM_FIELD)
            for seed in seeds:
                path = tmp / f"{el_type}_{seed}.txt"
                s, f = deformed_system(package, a, path, el_type=el_type)
                if package == "jax":
                    s.key = jax.random.PRNGKey(seed)
                else:
                    s.gen.manual_seed(seed)
                _, ok = s._relocalize(f)
                row = _stats_row(path)
                n = a["n"]
                moved = np.linalg.norm(np.asarray(s.map.lm_xyz)[:n]
                                       - a["pts"], axis=1)
                print(package, "ladder el_type", el_type, "seed", seed, "ok",
                      ok, {k: v for k, v in row.items() if "ime" not in k},
                      "lm_rigid == 2:", int((np.asarray(s.map.lm_rigid)[:n]
                                             == 2).sum()),
                      "moved:", int((moved > 0).sum()), "of", n)
        return
    scene, poses, centers, rest, field = cs.surface_scene()
    cam = Camera.create(fx=cs.FX, fy=cs.FX, cx=cs.WIDTH / 2,
                        cy=cs.HEIGHT / 2, bf=cs.BF)
    n1, n2 = cs.DEFORM_MAPPED, cs.DEFORM_MAPPED + cs.DEFORM_FRAMES
    s = system.SlamSystem(cam, system.SystemConfig(pipeline=False),
                          system.Sensor.RGBD, **kw)
    tracked = feed(s, [(cs.grey(scene, R, t), scene.depth_map(R, t))
                       for R, t in poses[:n1]], 0)
    s.shutdown()
    s.save_map(tmp / "m.npz")
    print(package, "mapped: tracked, ATE", tracked, "keyframes", s.n_keyframes,
          "landmarks", int(np.asarray(s.map.lm_valid).sum()))
    loc = system.SlamSystem(cam, system.SystemConfig(
        pipeline=False, deformable=True, reloc_test_all_frames=True,
        stats_reloc_path=str(tmp / "B.txt")), system.Sensor.RGBD, **kw)
    loc.load_map(tmp / "m.npz")
    loc.activate_localization_mode()
    frames = []
    for k, (R, t) in enumerate(poses[n1:n2]):
        scene.xyz = rest + cs.DEFORM_AMPLITUDE * k / (cs.DEFORM_FRAMES - 1) \
            * field
        frames.append((cs.grey(scene, R, t), scene.depth_map(R, t)))
    tracked = feed(loc, frames, n1)
    for row in (tmp / "B.txt").read_text().splitlines()[1:]:
        print(row)
    print(package, "localized: tracked, ATE", tracked, "relocs",
          loc.stats["relocs"], "kpi tp/fp/fn", loc.kpi.tp, loc.kpi.fp,
          loc.kpi.fn, "lm_rigid 1 / 2:",
          int((np.asarray(loc.map.lm_rigid) == 1).sum()),
          int((np.asarray(loc.map.lm_rigid) == 2).sum()))


if __name__ == "__main__":
    import sys
    if len(sys.argv) > 2:
        run_chip_phase(sys.argv[1], sys.argv[2],
                       [int(x) for x in sys.argv[3:]] or (0,))
    else:
        _print_nr_spread()
        _print_slice_spread()
