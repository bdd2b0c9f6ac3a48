"""The port's place recognition and rigid relocalization against the
reference (CPU): the bundled BoW vocabulary, the keyframe database, the PnP
solvers and RANSAC (with the reference's RANSAC draws passed in, ROADMAP Q3
#5), the candidate evaluation and full-map search on a reference map
carried across, and a LOST frame relocalized end to end on the
tests/test_e2e_rgbd.py scene, with the StatsReloc rows."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from _torch_port import jnp_dict, tnp
from test_bow_pnp import _pnp_scene
from orb_slam2_e_tpu.models import kf_database as JDB
from orb_slam2_e_tpu.models import relocalization as JRL
from orb_slam2_e_tpu.models.system import (SlamSystem as JSys,
                                           SystemConfig as JCfg,
                                           Sensor as JSensor)
from orb_slam2_e_tpu.ops import bow as jbow
from orb_slam2_e_tpu.ops import camera as jcam
from orb_slam2_e_tpu.ops import orb as jorb
from orb_slam2_e_tpu.ops import pnp as jpnp
from orb_slam2_e_tpu.utils.stats import RELOC_COLUMNS as J_RELOC_COLUMNS
from orb_slam2_e_tpu_torch.models import kf_database as TDB
from orb_slam2_e_tpu_torch.models import relocalization as TRL
from orb_slam2_e_tpu_torch.models.system import (BUNDLED_VOCAB, SlamSystem,
                                                 SystemConfig, Sensor)
from orb_slam2_e_tpu_torch.ops import bow as tbow
from orb_slam2_e_tpu_torch.ops import pnp as tpnp
from orb_slam2_e_tpu_torch.ops.camera import Camera
from orb_slam2_e_tpu_torch.utils import convert
from orb_slam2_e_tpu_torch.utils.stats import RELOC_COLUMNS
from orb_slam2_e_tpu_torch.utils.synthetic import (SyntheticScene,
                                                   orbit_trajectory)

# BoW: words are exact integer descents; a tf-idf row is one normalised
# f32 vector and a score one f32 sum over 10^5 words in another order
BOW_ATOL = 1e-6
# PnP: f32 SVD / eigh of a badly conditioned DLT system (s0/s10 of the
# 6-point samples 160-2600) through LAPACK in both packages. The
# reference's own answer moves when xyz and uv_n move by 1 ulp (24 seeds),
# and it rounds differently from one CPU type to another (XLA's CPU code is
# compiled for a machine type, so two machines disagree in the last bits):
#   solver        ref 1-ulp spread       ref vs f64 solve   port vs ref
#                 max|dR|   |dt|/|t|     |dt|/|t|           max|dR|  |dt|/|t|
#   dlt           2.8e-5    1.3e-4       4.8e-5             5.1e-6   5.5e-5
#   planar        1.4e-5    1.4e-4       -                  1.1e-5   1.2e-4
#   dlt_weighted  2.4e-5    3.5e-4       1.1e-4             2.1e-5   2.1e-4
# (the eigh of the 12x12 normal matrix squares the condition number). So R
# keeps an absolute bound, 3.5x its spread, and t is held relative to |t| at
# about 4x the solver's own spread: an absolute 1e-4 on t sat below the spread
# (one entry of size 5.98 moved 1.5e-4, 2.6e-5 relative). The DLT solvers
# are held to an f64 numpy solve of the same system at the same bounds.
PNP_R_ATOL = 1e-4
PNP_T_RTOL = {"dlt": 5e-4, "planar": 5e-4, "dlt_weighted": 1.5e-3}
# a relocalization candidate's pose is the dlt_weighted refit of its best
# hypothesis on ~100 inliers, so it is compared as a pose difference:
# rotation angle between the two quaternions and distance between the two
# camera centres. Under 1-ulp moves of the landmarks and keypoints (12
# seeds) the reference's candidate pose on this map moves up to 1.6e-5 rad
# and 1.43e-3 m (the inlier count does not move); the port stands 1.4e-5
# rad and 1.24e-3 m from it. Bounds: 6x and 3.5x that spread.
REFIT_ROT_MAX = 1e-4        # rad
REFIT_CENTRE_MAX = 5e-3     # metres
# the rigid pose LM from one shared starting pose is far steadier: the
# reference moves up to 1.2e-6 rad and 7.6e-6 m under the same 1-ulp
# moves, the port stands 8.1e-7 rad and 5.0e-6 m from it
LM_ROT_MAX = 2e-5           # rad
LM_CENTRE_MAX = 1e-4        # metres
# relocalization e2e (tests/test_e2e_rgbd.py scene, frame 10 blanked). The
# reference on the CPU: every frame but 10 tracked, relocalized at frame 11
# (relocs 1, kpi.tp 1), relocalized centre 0.0126 m from ground truth,
# every tracked centre within 0.017 m; with reloc_test_all_frames it
# relocalizes twice and loses frames 10 and 13 only. The port measured the
# same lost frames, relocalizations and KPI counts, its relocalized centre
# 0.0099 m and every tracked centre within 0.0144 m of ground truth.
CENTER_GT_ATOL = 0.05
BLANK = 10
SCENE = dict(n_points=500, seed=2, width=480, height=360, fx=400, fy=400,
             cx=240, cy=180)
CAM = dict(fx=400, fy=400, cx=240, cy=180, bf=40.0, width=480, height=360)
CFG = dict(max_keyframes=32, max_points=8192, n_features=600, n_levels=4,
           max_frames_between_kf=4, pipeline=False, loop_closing=False)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def vocabs():
    return jbow.load_vocabulary(BUNDLED_VOCAB), \
        tbow.load_vocabulary(BUNDLED_VOCAB, device="cpu")


@pytest.fixture(scope="module")
def frame_descs():
    """Descriptors of two views of the scene (reference extractor)."""
    scene = SyntheticScene(**SCENE)
    poses, _ = orbit_trajectory(n_frames=16, radius=0.9, forward=0.04)
    ex = jorb.OrbExtractor(600, 1.2, 4, use_pallas=False)
    return [ex(jnp.asarray(scene.render(*poses[k]))) for k in (0, 6)]


def test_bow_words_and_vectors_match(vocabs, frame_descs):
    jv, tv = vocabs
    assert (tv.k, tv.L, tv.n_words) == (jv.k, jv.L, jv.n_words)
    for f in frame_descs:
        jw, _ = jbow.transform(jv, f.desc, f.valid)
        tw, _ = tbow.transform(tv, _t(f.desc), _t(f.valid))
        np.testing.assert_array_equal(tnp(tw), np.asarray(jw))
        jvec = jbow.bow_vector(jv, jw, f.valid)
        tvec = tbow.bow_vector(tv, tw, _t(f.valid))
        np.testing.assert_allclose(tnp(tvec), np.asarray(jvec),
                                   atol=BOW_ATOL)
        assert abs(float(tvec.sum()) - 1.0) < 1e-5


def test_vocabulary_arrays_round_trip(vocabs):
    _, tv = vocabs
    with np.load(BUNDLED_VOCAB) as d:
        ref = dict(d)
    back = tbow.vocabulary_to_arrays(tv)
    for k in ("voc_nodes_packed", "voc_k", "voc_L", "voc_idf"):
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
    again = tbow.vocabulary_from_arrays(back, device="cpu")
    assert again.node_bits.dtype == torch.int8
    assert torch.equal(again.node_bits, tv.node_bits)
    assert tbow.vocabulary_from_arrays({}, device="cpu") is None


def test_train_vocabulary_matches_reference():
    rng = np.random.RandomState(0)
    protos = rng.randint(0, 256, (20, 32)).astype(np.uint8)
    corpus = np.repeat(protos, 30, axis=0)
    flips = rng.randint(0, 32, len(corpus))
    corpus[np.arange(len(corpus)), flips] ^= rng.randint(
        1, 255, len(corpus)).astype(np.uint8)
    jv = jbow.train_vocabulary(corpus, k=6, L=3, iters=4)
    tv = tbow.train_vocabulary(corpus, k=6, L=3, iters=4, device="cpu")
    np.testing.assert_array_equal(tnp(tv.node_bits), np.asarray(jv.node_bits))
    np.testing.assert_array_equal(tnp(tv.idf), np.asarray(jv.idf))


def test_database_candidates_match(vocabs, frame_descs):
    jv, tv = vocabs
    vecs = []
    rng = np.random.RandomState(1)
    for f in frame_descs * 3:            # six rows, pairs of near-copies
        keep = np.asarray(f.valid) & (rng.rand(f.valid.shape[0]) < 0.8)
        w, _ = jbow.transform(jv, f.desc, jnp.asarray(keep))
        vecs.append(np.asarray(jbow.bow_vector(jv, w, jnp.asarray(keep))))
    jdb = JDB.BowDatabase.create(8, jv.n_words)
    tdb = TDB.BowDatabase.create(8, tv.n_words, device="cpu")
    for slot, v in zip((0, 1, 2, 4, 5, 7), vecs):
        jdb = jdb.add(jnp.int32(slot), jnp.asarray(v))
        tdb = tdb.add(slot, _t(v))
    jdb, tdb = jdb.erase(jnp.int32(2)), tdb.erase(2)
    np.testing.assert_array_equal(tnp(tdb.filled), np.asarray(jdb.filled))
    q = vecs[0]
    jc, js = JDB.detect_relocalization_candidates(jdb, jnp.asarray(q))
    tc, ts = TDB.detect_relocalization_candidates(tdb, _t(q))
    np.testing.assert_array_equal(tnp(tc), np.asarray(jc))
    np.testing.assert_allclose(tnp(ts), np.asarray(js), atol=BOW_ATOL)
    np.testing.assert_allclose(tnp(TDB.query_scores(tdb, _t(q))),
                               np.asarray(JDB.query_scores(jdb,
                                                           jnp.asarray(q))),
                               atol=BOW_ATOL)


def _assert_pnp_close(R, t, R_ref, t_ref, solver, what):
    """R entry by entry; t as |dt| / |t_ref| per solution."""
    R, t, R_ref, t_ref = (np.asarray(x, np.float64)
                          for x in (R, t, R_ref, t_ref))
    np.testing.assert_allclose(R, R_ref, atol=PNP_R_ATOL, err_msg=what)
    rel = (np.linalg.norm(t - t_ref, axis=-1)
           / np.linalg.norm(t_ref, axis=-1))
    assert np.all(rel < PNP_T_RTOL[solver]), (what, rel)


def _dlt_f64(xyz, uv_n, w=None):
    """The (weighted) DLT system of pnp_dlt solved in float64 numpy."""
    xyz, uv_n = np.asarray(xyz, np.float64), np.asarray(uv_n, np.float64)
    n = len(xyz)
    Xh = np.concatenate([xyz, np.ones((n, 1))], 1)
    zeros = np.zeros((n, 4))
    A = np.concatenate([
        np.concatenate([Xh, zeros, -uv_n[:, :1] * Xh], 1),
        np.concatenate([zeros, Xh, -uv_n[:, 1:2] * Xh], 1)], 0)
    if w is not None:
        A = A * np.sqrt(np.concatenate([w, w]).astype(np.float64))[:, None]
    P = np.linalg.svd(A, full_matrices=True)[2][11].reshape(3, 4)
    P = P * np.sign(np.linalg.det(P[:, :3]))
    scale = abs(np.linalg.det(P[:, :3])) ** (1.0 / 3.0)
    U, _, Vt = np.linalg.svd(P[:, :3] / scale)
    R = U @ Vt
    return R * np.sign(np.linalg.det(R)), P[:, 3] / scale


def _pose_difference(p7_a, p7_b):
    """(rotation angle in rad, camera-centre distance) between two pose7
    (unit quaternion w,x,y,z of Rcw, then tcw)."""
    def split(p7):
        p7 = np.asarray(p7, np.float64)
        w, x, y, z = q = p7[:4] / np.linalg.norm(p7[:4])
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        return q, -R.T @ p7[4:]
    (qa, ca), (qb, cb) = split(p7_a), split(p7_b)
    angle = 2.0 * np.arccos(min(1.0, abs(float(qa @ qb))))
    return angle, float(np.linalg.norm(ca - cb))


def _uv_n(uv, K):
    uv = np.asarray(uv, np.float64)
    return ((np.concatenate([uv, np.ones((len(uv), 1))], 1)
             @ np.linalg.inv(np.asarray(K)).T)[:, :2]).astype(np.float32)


@pytest.mark.parametrize("solver", ["dlt", "planar", "dlt_weighted"])
def test_pnp_solvers_match(solver):
    xyz, uv, K, R_true, t_true, _ = _pnp_scene(40, noise=0.3,
                                               outlier_frac=0.0, seed=2)
    uvn = _uv_n(uv, K)
    if solver == "planar":                # coplanar sample (z = 5 plane)
        xyz = np.asarray(xyz).copy()
        xyz[:, 2] = 5.0
        xc = xyz @ R_true.T + t_true
        uvn = (xc[:, :2] / xc[:, 2:]).astype(np.float32)
    xyz = np.asarray(xyz, np.float32)
    if solver == "dlt_weighted":
        w = (np.arange(40) % 3 != 0).astype(np.float32)
        jR, jt = jpnp.pnp_dlt_weighted(jnp.asarray(xyz), jnp.asarray(uvn),
                                       jnp.asarray(w))
        tR, tt = tpnp.pnp_dlt_weighted(_t(xyz), _t(uvn), _t(w))
    else:
        jf = getattr(jpnp, f"pnp_{solver}")
        tf = getattr(tpnp, f"pnp_{solver}")
        # a batch of 6-point samples, as RANSAC solves them
        sets = np.random.RandomState(3).rand(16, 40).argsort(1)[:, :6]
        jR, jt = jax.vmap(lambda i: jf(jnp.asarray(xyz)[i],
                                       jnp.asarray(uvn)[i]))(
            jnp.asarray(sets))
        tR, tt = tf(_t(xyz)[_t(sets)], _t(uvn)[_t(sets)])
    _assert_pnp_close(tnp(tR), tnp(tt), jR, jt, solver, "port vs reference")
    if solver == "dlt":
        R64, t64 = map(np.stack, zip(*[_dlt_f64(xyz[i], uvn[i])
                                       for i in sets]))
    elif solver == "dlt_weighted":
        R64, t64 = _dlt_f64(xyz, uvn, w)
    else:
        return
    _assert_pnp_close(tnp(tR), tnp(tt), R64, t64, solver, "port vs f64")
    _assert_pnp_close(jR, jt, R64, t64, solver, "reference vs f64")


def _ref_pnp_draws(key, valid, n_hyp):
    """The reference's ransac_pnp draws: split into (global sets, anchors)
    keys, Gumbel top-k sets and Gumbel argmax anchors."""
    n_loc = int(round(n_hyp * 0.5))
    kg, kl = jax.random.split(key)
    logits = jnp.where(valid, 0.0, -1e9)
    g = jax.random.gumbel(kg, (n_hyp - n_loc, valid.shape[0])) + logits[None]
    ga = jax.random.gumbel(kl, (n_loc, valid.shape[0])) + logits[None]
    return (_t(jax.lax.top_k(g, 6)[1]), _t(jnp.argmax(ga, axis=1)))


def test_ransac_pnp_with_reference_draws():
    xyz, uv, K, *_ = _pnp_scene(150, outlier_frac=0.3, seed=1)
    valid = jnp.asarray(np.arange(150) % 11 != 0)
    key = jax.random.PRNGKey(0)
    rj = jpnp.ransac_pnp(key, xyz, uv, valid, K, n_hyp=128)
    sets, anchors = _ref_pnp_draws(key, valid, 128)
    rt = tpnp.ransac_pnp(None, _t(xyz), _t(uv), _t(valid), _t(K), n_hyp=128,
                         sets=sets, anchors=anchors)
    np.testing.assert_array_equal(tnp(rt.n_inliers), np.asarray(rj.n_inliers))
    np.testing.assert_array_equal(tnp(rt.inliers_best),
                                  np.asarray(rj.inliers_best))
    # the best hypothesis is the dlt_weighted refit over its inliers
    _assert_pnp_close(tnp(rt.R[0]), tnp(rt.t[0]), rj.R[0], rj.t[0],
                      "dlt_weighted", "refit of the best hypothesis")
    assert int(rt.n_inliers[0]) > 80


# ---------------------------------------------------------------------------
# Relocalization end to end, and its stages on the reference's map
# ---------------------------------------------------------------------------

def _centre(pose):
    if pose is None:
        return None
    R, t = (np.asarray(x, np.float64) for x in pose)
    return -R.T @ t


def _frames():
    scene = SyntheticScene(**SCENE)
    poses, centers = orbit_trajectory(n_frames=16, radius=0.9, forward=0.04)
    frames = [(scene.render(R, t), scene.depth_map(R, t)) for R, t in poses]
    frames[BLANK] = (np.zeros_like(frames[BLANK][0]), frames[BLANK][1])
    return frames, centers


def _run_both(frames, tmp_path, **extra):
    sj = JSys(jcam.Camera.create(**CAM),
              JCfg(**CFG, stats_reloc_path=str(tmp_path / "j.txt"), **extra),
              JSensor.RGBD)
    st = SlamSystem(Camera.create(**CAM),
                    SystemConfig(**CFG, stats_reloc_path=str(
                        tmp_path / "t.txt"), **extra), Sensor.RGBD,
                    device="cpu")
    out = {"jax": (sj, []), "torch": (st, [])}
    for k, (img, depth) in enumerate(frames):
        for s, cen in out.values():
            cen.append(_centre(s.track_rgbd(img, depth, k / 30.0)))
    return out


@pytest.fixture(scope="module")
def reloc_run(tmp_path_factory):
    frames, centers = _frames()
    tmp = tmp_path_factory.mktemp("reloc")
    return _run_both(frames, tmp), centers, tmp


@pytest.mark.e2e
def test_lost_frame_relocalizes_as_the_reference(reloc_run):
    out, centers, _ = reloc_run
    (sj, cj), (st, ct) = out["jax"], out["torch"]
    lost_j = [k for k, c in enumerate(cj) if c is None]
    lost_t = [k for k, c in enumerate(ct) if c is None]
    assert lost_j == [BLANK] and lost_t == lost_j, (lost_j, lost_t)
    assert st.stats["relocs"] == sj.stats["relocs"] == 1
    assert st.kpi.tp == sj.kpi.tp == 1
    assert (st.kpi.fp, st.kpi.fn) == (sj.kpi.fp, sj.kpi.fn)
    err = [np.linalg.norm(c - g) for c, g in zip(ct, centers)
           if c is not None]
    assert max(err) < CENTER_GT_ATOL, err


@pytest.mark.e2e
def test_stats_reloc_rows(reloc_run):
    """StatsReloc rows carry the reference's columns; the non-rigid fields
    read as the reference writes them outside the deformable mode."""
    _, _, tmp = reloc_run
    assert RELOC_COLUMNS == J_RELOC_COLUMNS
    rows_t = (tmp / "t.txt").read_text().splitlines()
    rows_j = (tmp / "j.txt").read_text().splitlines()
    assert rows_t[0].split("\t") == RELOC_COLUMNS
    assert len(rows_t) == len(rows_j) == 2       # header + the one attempt
    vt = dict(zip(RELOC_COLUMNS, rows_t[1].split("\t")))
    vj = dict(zip(RELOC_COLUMNS, rows_j[1].split("\t")))
    assert vt["Frame"] == vj["Frame"] == str(BLANK + 1)
    assert vt["Accepted"] == vj["Accepted"] == "1"
    assert vt["Stage"] == vj["Stage"]
    for s in (1, 2, 3):
        assert vt[f"nGoodNR_S{s}"] == vj[f"nGoodNR_S{s}"]
        assert vt[f"nGoodNR_S{s}"] in ("", "-1")
    assert vt["nGoodNR_S1"] == "-1"
    assert int(vt["KF_candidates"]) > 0 and int(vt["Inliers_PnP_R"]) >= 4


def test_candidates_and_fullmap_search_on_reference_map(reloc_run):
    """The reference's end map and a fresh view carried across: the same
    BoW candidates, the same PnP outcome per candidate with the reference's
    draws, and the same full-map search from that pose."""
    out, _, _ = reloc_run
    sj, _ = out["jax"]
    scene = SyntheticScene(**SCENE)
    poses, _ = orbit_trajectory(n_frames=16, radius=0.9, forward=0.04)
    img, depth = scene.render(*poses[12]), scene.depth_map(*poses[12])
    fj = sj._make_frame(jnp.asarray(img), jnp.asarray(depth))
    ft = convert.frame_from_numpy(jnp_dict(fj), "cpu")
    tmap = convert.map_state_from_numpy(jnp_dict(sj.map), "cpu")
    tv = tbow.load_vocabulary(BUNDLED_VOCAB, device="cpu")
    tdb = TDB.BowDatabase(vecs=_t(sj.bow_db.vecs), filled=_t(sj.bow_db.filled))
    q_j = sj._bow_vec(fj.desc, fj.valid)
    q_t = tbow.bow_vector(tv, tbow.transform(tv, ft.desc, ft.valid)[0],
                          ft.valid)
    np.testing.assert_allclose(tnp(q_t), np.asarray(q_j), atol=BOW_ATOL)
    cj, sc_j = JDB.detect_relocalization_candidates(sj.bow_db, q_j)
    ct, sc_t = TDB.detect_relocalization_candidates(tdb, q_t)
    np.testing.assert_array_equal(tnp(ct), np.asarray(cj))
    ok = sc_j > 0
    assert int(ok.sum()) >= 2
    cam_t = convert.camera_from_numpy(jnp_dict(sj.cam), "cpu")
    tcfg = TRL.TrackConfig(*sj.track_cfg)
    key = jax.random.PRNGKey(7)
    pj, nj, pidj = JRL.relocalize_candidates(key, sj.cam, sj.track_cfg,
                                             sj.map, fj, cj, ok)
    # the reference's draws: one key split per candidate, in scan order
    draws, k = [], key
    for kf in np.asarray(cj):
        k, sub = jax.random.split(k)
        _, pair, _, _ = TRL.candidate_matches(tmap, ft, int(kf))
        enough = bool(pair.sum() >= TRL.MIN_BOW_MATCHES)
        draws.append(_ref_pnp_draws(sub, jnp.asarray(tnp(pair) & enough),
                                    TRL.N_HYP))
    pt, nt, pidt = TRL.relocalize_candidates(None, cam_t, tcfg, tmap, ft,
                                             _t(cj), _t(ok), sets=draws)
    assert int(nt) == int(nj) >= TRL.MIN_BOW_MATCHES
    np.testing.assert_array_equal(tnp(pidt), np.asarray(pidj))
    angle, dist = _pose_difference(tnp(pt), pj)
    assert angle < REFIT_ROT_MAX and dist < REFIT_CENTRE_MAX, (angle, dist)
    # full-map search from the reference's pose
    fj2, bj = JRL.fullmap_search(sj.cam, sj.track_cfg, sj.map,
                                 fj._replace(pose7=pj, point_ids=pidj),
                                 jnp.float32(15.0), jnp.int32(60))
    ft2, bt = TRL.fullmap_search(cam_t, tcfg, tmap, ft._replace(
        pose7=_t(pj), point_ids=_t(pidj)), 15.0, 60)
    assert int(bt) == int(bj) >= TRL.MIN_PNP_FULLMAP
    np.testing.assert_array_equal(tnp(ft2.point_ids),
                                  np.asarray(fj2.point_ids))
    # the S2 widening as the system runs it: search at radius 10, then the
    # rigid pose LM
    fj3, nj3 = JRL.fullmap_search_and_optimize(sj.cam, sj.track_cfg, sj.map,
                                               fj2, 10.0)
    ft3, nt3 = TRL.fullmap_search_and_optimize(cam_t, tcfg, tmap, ft2, 10.0)
    assert int(nt3) == int(nj3) >= TRL.RELOC_GOOD
    np.testing.assert_array_equal(tnp(ft3.point_ids),
                                  np.asarray(fj3.point_ids))
    angle, dist = _pose_difference(tnp(ft3.pose7), fj3.pose7)
    assert angle < LM_ROT_MAX and dist < LM_CENTRE_MAX, (angle, dist)


@pytest.mark.e2e
def test_kpi_protocol_matches_reference(tmp_path):
    """reloc_test_all_frames: after each TP the tracker is forced LOST and
    relocalizes again; the port loses the same frames and counts the same
    relocalizations and KPI events as the reference."""
    frames, centers = _frames()
    out = _run_both(frames, tmp_path, reloc_test_all_frames=True)
    (sj, cj), (st, ct) = out["jax"], out["torch"]
    lost_j = [k for k, c in enumerate(cj) if c is None]
    lost_t = [k for k, c in enumerate(ct) if c is None]
    assert lost_j == [BLANK, BLANK + 3] and lost_t == lost_j, (lost_j, lost_t)
    assert st.stats["relocs"] == sj.stats["relocs"] == 2
    assert (st.kpi.tp, st.kpi.fp, st.kpi.fn) == (sj.kpi.tp, sj.kpi.fp,
                                                 sj.kpi.fn)
    err = [np.linalg.norm(c - g) for c, g in zip(ct, centers)
           if c is not None]
    assert max(err) < CENTER_GT_ATOL, err


# ---------------------------------------------------------------------------
# `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_reloc.py` prints the reference's
# own 1-ulp spread, which the PnP and pose-difference bounds above come from
# ---------------------------------------------------------------------------

def _ulp_moved(a, rng):
    """Each float32 entry moved by -1, 0 or +1 ulp."""
    a = np.asarray(a, np.float32)
    step = rng.randint(-1, 2, a.shape)
    up = np.nextafter(a, np.float32(np.inf))
    down = np.nextafter(a, np.float32(-np.inf))
    return np.where(step > 0, up, np.where(step < 0, down, a))


def _print_pnp_spread(n_seeds=24):
    xyz, uv, K, R_true, t_true, _ = _pnp_scene(40, noise=0.3,
                                               outlier_frac=0.0, seed=2)
    sets = jnp.asarray(np.random.RandomState(3).rand(16, 40).argsort(1)[:, :6])
    w = jnp.asarray((np.arange(40) % 3 != 0).astype(np.float32))
    for solver in ("dlt", "planar", "dlt_weighted"):
        x, u = np.asarray(xyz, np.float32), _uv_n(uv, K)
        if solver == "planar":
            x = x.copy()
            x[:, 2] = 5.0
            xc = x @ R_true.T + t_true
            u = (xc[:, :2] / xc[:, 2:]).astype(np.float32)

        def solve(x, u):
            x, u = jnp.asarray(x), jnp.asarray(u)
            if solver == "dlt_weighted":
                R, t = jpnp.pnp_dlt_weighted(x, u, w)
                return np.asarray(R)[None], np.asarray(t)[None]
            f = getattr(jpnp, f"pnp_{solver}")
            R, t = jax.vmap(lambda i: f(x[i], u[i]))(sets)
            return np.asarray(R), np.asarray(t)

        R0, t0 = solve(x, u)
        dR = dt = 0.0
        for seed in range(n_seeds):
            rng = np.random.RandomState(100 + seed)
            R1, t1 = solve(_ulp_moved(x, rng), _ulp_moved(u, rng))
            dR = max(dR, np.abs(R1 - R0).max())
            dt = max(dt, (np.linalg.norm(t1 - t0, axis=-1)
                          / np.linalg.norm(t0, axis=-1)).max())
        print(f"pnp_{solver}: reference 1-ulp spread max|dR| {dR:.3g}, "
              f"|dt|/|t| {dt:.3g}")


def _print_candidate_spread(n_seeds=12):
    frames, _ = _frames()
    sj = JSys(jcam.Camera.create(**CAM), JCfg(**CFG), JSensor.RGBD)
    for k, (img, depth) in enumerate(frames):
        sj.track_rgbd(img, depth, k / 30.0)
    scene = SyntheticScene(**SCENE)
    poses, _ = orbit_trajectory(n_frames=16, radius=0.9, forward=0.04)
    fj = sj._make_frame(jnp.asarray(scene.render(*poses[12])),
                        jnp.asarray(scene.depth_map(*poses[12])))
    cj, sc = JDB.detect_relocalization_candidates(
        sj.bow_db, sj._bow_vec(fj.desc, fj.valid))
    key = jax.random.PRNGKey(7)

    def run(state, frame):
        p, n, pid = JRL.relocalize_candidates(key, sj.cam, sj.track_cfg,
                                              state, frame, cj, sc > 0)
        f2, _ = JRL.fullmap_search(sj.cam, sj.track_cfg, state,
                                   frame._replace(pose7=p, point_ids=pid),
                                   jnp.float32(15.0), jnp.int32(60))
        f3, n3 = JRL.fullmap_search_and_optimize(sj.cam, sj.track_cfg, state,
                                                 f2, 10.0)
        return p, int(n), f3.pose7, int(n3)

    p0, n0, q0, m0 = run(sj.map, fj)
    for seed in range(n_seeds):
        rng = np.random.RandomState(200 + seed)
        p1, n1, q1, m1 = run(
            sj.map._replace(lm_xyz=jnp.asarray(_ulp_moved(sj.map.lm_xyz,
                                                          rng))),
            fj._replace(uvr=jnp.asarray(_ulp_moved(fj.uvr, rng))))
        print(f"seed {seed}: candidate inliers {n1} (base {n0}), "
              "(rad, m) %.3g %.3g; after the pose LM inliers %d (base %d), "
              "(rad, m) %.3g %.3g" % (*_pose_difference(p1, p0), m1, m0,
                                      *_pose_difference(q1, q0)))


if __name__ == "__main__":
    _print_pnp_spread()
    _print_candidate_spread()
