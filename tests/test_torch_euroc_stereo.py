"""The EuRoC-stereo proxy's map slide (ROADMAP Q3 #I), both packages on the
CPU from one state.

On the 120-frame EuRoC proxy (`make_proxy_euroc`, seed 2) the frames 1-5
are tracked almost in place in both packages (a sideways move read as a
turn: the points lie 2.4-4.3 m away), so from frame 6 on every keyframe
but slot 0 (frame 0, the local BA's gauge) stands about 38 mm off the
frame-0 geometry. A later local BA may pull the whole map back onto slot
0's observations in one step: every live keyframe but slot 0 moves about
40 mm, the frames after track the moved map, and the frame ATE over all
frames doubles. The port's run on 4 threads does it in the pass of the
keyframe inserted at frame 90.

The fixture `fixtures/euroc_stereo_frame90.npz` holds the port's pipelined
loop state just before frame 90 (the map, frames 89, 90 and 91, the
velocity and the reference keyframe), written by

    python tests/test_torch_euroc_stereo.py fixture DATA_DIR

(the proxy generated under DATA_DIR where absent; 4 torch threads, the
first 92 frames of `examples.stereo_euroc`). The tests feed it to both
packages: frame 90's tracking, the insertion and each stage of the mapping
pass from the same inputs, held to `test_mapping_pass_matches`'s
tolerances; the local BA moves the map in both, also on 1-ulp moved
inputs; and the port's frame 91 lands inside the reference's spread.

    python tests/test_torch_euroc_stereo.py spread [--seeds 1,2,3]

prints the reference's pass and frame 91 from the fixture with its map and
frame 90 moved by one ulp per seed (the numbers behind REF_STEP_91), and

    python tests/test_torch_euroc_stereo.py full DATA_DIR OUT_DIR
        [--package jax|torch] [--seeds=-1,1,2,3] [--threads 4] [--jobs 3]

runs `stereo_euroc` over the 120 frames, once per seed (-1: the images as
read; else every rectified image moved by one ulp, drawn from the seed),
and prints per run the frame ATE, the insertions that moved the map, and
the per-frame error aligned on frames 0-79;

    python tests/test_torch_euroc_stereo.py perframe GROUNDTRUTH TRAJ...

prints the same for TUM trajectory files, with the error of some frames
against ground truth in frame 0's coordinates (no fitted alignment).
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
sys.path[:0] = [str(HERE), str(REPO)]

from _torch_port import ulp_moved  # noqa: E402
from orb_slam2_e_tpu.models import local_mapping as JLM  # noqa: E402
from orb_slam2_e_tpu.models import system as JS  # noqa: E402
from orb_slam2_e_tpu.models import tracking as JT  # noqa: E402
from orb_slam2_e_tpu.models.frame import Frame as JFrame  # noqa: E402
from orb_slam2_e_tpu.models.map_state import MapState as JMap  # noqa: E402
from orb_slam2_e_tpu.utils import config as jconfig  # noqa: E402
from test_torch_ba_mapping import (MAP_POSE_ATOL,  # noqa: E402
                                   MAP_XYZ_MAX_ATOL, MAP_XYZ_MEDIAN_ATOL)
from orb_slam2_e_tpu_torch.models import local_mapping as TLM  # noqa: E402
from orb_slam2_e_tpu_torch.models import system as TS  # noqa: E402
from orb_slam2_e_tpu_torch.models import tracking as TT  # noqa: E402
from orb_slam2_e_tpu_torch.models.frame import Frame  # noqa: E402
from orb_slam2_e_tpu_torch.models.map_state import MapState  # noqa: E402
from orb_slam2_e_tpu_torch.utils import config as tconfig  # noqa: E402
from orb_slam2_e_tpu_torch.utils import convert  # noqa: E402
from orb_slam2_e_tpu_torch.utils.trajectory import (  # noqa: E402
    ate_rmse, load_tum, umeyama_alignment)

FIXTURE = HERE / "fixtures" / "euroc_stereo_frame90.npz"
FRAME = 90                 # the insertion that moves the map
FIXTURE_THREADS = 4        # the port's CPU run that slides at frame 90
STAGES = ("cull", "triangulate", "fuse", "refresh", "local_ba",
          "cull_keyframes")
# the local BA from the fixture's refreshed map (both packages, every
# 1-ulp move tried): every live keyframe but slot 0 moves 38.8-44.3 mm
SLIDE_MM = (30.0, 50.0)
# frame 90 -> 91 camera-centre step (m) of the reference chained from the
# fixture, unmoved and with the map and frame 90 moved by one ulp (seeds
# 1-5), as the `spread` mode prints it: 0.037946, 0.037890, 0.037890,
# 0.037887, 0.037881, 0.037892
REF_STEP_91 = (0.037881, 0.037946)
GT_STEP_91 = 0.0146        # ground truth's step, m


# ---------------------------------------------------------------- fixture

def _compact(arrays: dict, default: dict, rows: str) -> dict:
    """The fields whose name starts with `rows` ("kf_" / "lm_") cut after
    the last row that differs from an empty map's."""
    keys = [k for k in arrays if k.startswith(rows)]
    n = 0
    for k in keys:
        diff = np.asarray(arrays[k] != default[k])
        diff = diff.reshape(diff.shape[0], -1).any(1)
        if diff.any():
            n = max(n, int(np.nonzero(diff)[0][-1]) + 1)
    return {k: arrays[k][:n] for k in keys}


def _empty_map(K: int, F: int, P: int) -> dict:
    return convert.to_numpy(MapState.create(K, F, P, device="cpu"))


def make_fixture(data_dir: Path, out: Path = FIXTURE):
    """Run the port's stereo_euroc over the proxy's first FRAME + 2 frames
    on the CPU and save the loop state before frame FRAME and the features
    of frame FRAME + 1."""
    from orb_slam2_e_tpu_torch.examples import stereo_euroc
    from orb_slam2_e_tpu_torch.tools import run_proxy_eval as rpe
    torch.set_num_threads(FIXTURE_THREADS)
    d = rpe.ensure_stereo_sequence("euroc", argparse.Namespace(
        frames=120, device="cpu", data_dir=str(data_dir)))
    stamps = (d / "timestamps.txt").read_text().split()[:FRAME + 2]
    work = Path(data_dir) / "fixture_work"
    work.mkdir(parents=True, exist_ok=True)
    (work / "timestamps.txt").write_text("\n".join(stamps) + "\n")
    saved = {}
    step = TS.SlamSystem._super

    def hook(self, loop, frame, frame_id, timestamp, mapping_on):
        if frame_id == FRAME:
            saved.update(loop=loop, frame=frame, timestamp=timestamp)
        if frame_id == FRAME + 1:
            saved["next"] = frame
        return step(self, loop, frame, frame_id, timestamp, mapping_on)
    TS.SlamSystem._super = hook
    cwd = os.getcwd()
    try:
        os.chdir(work)
        stereo_euroc.main([str(d / "settings.yaml"), str(d),
                           str(work / "timestamps.txt"), "--device", "cpu"])
    finally:
        os.chdir(cwd)
        TS.SlamSystem._super = step
    loop = saved["loop"]
    m = convert.to_numpy(loop.map)
    K, F = m["kf_kp_point"].shape
    P = m["lm_xyz"].shape[0]
    empty = _empty_map(K, F, P)
    arrays = {f"map_{k}": v for k, v in {
        **_compact(m, empty, "kf_"), **_compact(m, empty, "lm_"),
        "next_seq": m["next_seq"]}.items()}
    for name, fr in (("last", loop.last_frame), ("frame", saved["frame"]),
                     ("next", saved["next"])):
        arrays.update({f"{name}_{k}": v
                       for k, v in convert.to_numpy(fr).items()})
    arrays.update(
        vel7=loop.vel7.numpy(), vel_ok=loop.vel_ok.numpy(),
        ref_kf=loop.ref_kf.numpy(), capacities=np.int32([K, F, P]),
        frame_id=np.int32(FRAME), timestamp=np.float64(saved["timestamp"]),
        settings=np.str_((d / "settings.yaml").read_text()))
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out} ({out.stat().st_size} bytes)")


def load_case(tmp: Path):
    """The fixture as numpy dicts, with the map at the run's capacities,
    and both packages' camera and configurations from its settings."""
    z = np.load(FIXTURE)
    K, F, P = (int(x) for x in z["capacities"])
    m = _empty_map(K, F, P)
    for k in z.files:
        if k.startswith("map_"):
            name = k[4:]
            if name == "next_seq":
                m[name] = z[k]
            else:
                m[name][:len(z[k])] = z[k]
    frames = {name: {k: z[f"{name}_{k}"] for k in Frame._fields}
              for name in ("last", "frame", "next")}
    settings = tmp / "settings.yaml"
    settings.write_text(str(z["settings"]))
    s_t, s_j = (tconfig.load_settings(str(settings)),
                jconfig.load_settings(str(settings)))
    tsys = TS.SlamSystem(tconfig.camera_from_settings(s_t, device="cpu"),
                         TS.SystemConfig.from_settings(s_t),
                         TS.Sensor.STEREO, device="cpu")
    jsys = JS.SlamSystem(jconfig.camera_from_settings(s_j),
                         JS.SystemConfig.from_settings(s_j), JS.Sensor.STEREO)
    return dict(map=m, **frames, vel7=z["vel7"], vel_ok=bool(z["vel_ok"]),
                ref_kf=int(z["ref_kf"]), frame_id=int(z["frame_id"]),
                timestamp=float(z["timestamp"]), tsys=tsys, jsys=jsys)


# ------------------------------------------------------------ the two chains

def _J(cls, arrays):
    return cls(**{k: jnp.asarray(arrays[k]) for k in cls._fields})


def _np(nt) -> dict:
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def reference_chain(case, m=None, frame=None):
    """The reference's frame FRAME (tracking, insertion into the free slot,
    each stage of the mapping pass) and frame FRAME + 1's tracking, each
    stage fed the previous one's output. Returns {stage: (input map,
    output map, count)} with "track" / "track_next" holding (frame out,
    flags4) and the inputs the port is fed."""
    js = case["jsys"]
    m = case["map"] if m is None else m
    frame = case["frame"] if frame is None else frame
    ref_kf = max(case["ref_kf"], 0)
    out = {}
    m1, f1, vel, flags = JT.track_frame_fused(
        js.cam, js.track_cfg, _J(JMap, m), _J(JFrame, frame),
        _J(JFrame, case["last"]), jnp.asarray(case["vel7"]),
        jnp.bool_(case["vel_ok"]), jnp.int32(ref_kf))
    out["track"] = dict(map_in=m, frame_in=frame, map=_np(m1),
                        frame=_np(f1), flags=np.asarray(flags), vel=vel)
    st, fr, slot = JT.insert_keyframe(
        js.cam, js.track_cfg, m1, f1, jnp.int32(case["frame_id"]),
        jnp.float32(case["timestamp"]), jnp.int32(ref_kf))
    slot = int(slot)
    out["insert"] = dict(map_in=_np(m1), frame_in=_np(f1), map=_np(st),
                         frame=_np(fr), slot=slot)
    kf = jnp.int32(slot)
    for stage in STAGES:
        before = _np(st)
        if stage == "cull":
            st, n = JLM.cull_map_points(js.map_cfg, st, kf)
        elif stage == "triangulate":
            st, n = JLM.triangulate_with_neighbors(js.cam, js.map_cfg, st,
                                                   kf)
        elif stage == "fuse":
            st, n, _ = JLM.fuse_neighbors(js.cam, js.map_cfg, st, kf)
        elif stage == "refresh":
            st, n = JLM.refresh_landmarks(js.map_cfg, st, kf), 0
        elif stage == "local_ba":
            st, _, n = JLM.local_ba(js.cam, js.map_cfg, st, kf)
        else:
            st, n = JLM.cull_keyframes(js.map_cfg, st, kf)
        out[stage] = dict(map_in=before, map=_np(st), count=np.asarray(n))
    m2, f2, _, flags2 = JT.track_frame_fused(
        js.cam, js.track_cfg, st, _J(JFrame, case["next"]), fr, vel,
        jnp.bool_(True), kf)
    out["track_next"] = dict(map_in=_np(st), frame_in=case["next"],
                             last_in=_np(fr), vel_in=np.asarray(vel),
                             map=_np(m2), frame=_np(f2),
                             flags=np.asarray(flags2))
    return out


def port_stage(case, stage: str, ref: dict):
    """The port's `stage` on the reference's input to it: (map, count) or,
    for the tracking stages, (map, frame, flags)."""
    ts = case["tsys"]
    r = ref[stage]
    T = convert.map_state_from_numpy
    Fr = convert.frame_from_numpy
    ref_kf = max(case["ref_kf"], 0)
    slot = ref["insert"]["slot"]
    if stage == "track":
        m, f, _, fl = TT.track_frame_fused(
            ts.cam, ts.track_cfg, T(r["map_in"], "cpu"),
            Fr(r["frame_in"], "cpu"), Fr(case["last"], "cpu"),
            torch.from_numpy(case["vel7"]), case["vel_ok"],
            torch.tensor(ref_kf, dtype=torch.int32))
        return convert.to_numpy(m), convert.to_numpy(f), fl.numpy()
    if stage == "track_next":
        m, f, _, fl = TT.track_frame_fused(
            ts.cam, ts.track_cfg, T(r["map_in"], "cpu"),
            Fr(r["frame_in"], "cpu"), Fr(r["last_in"], "cpu"),
            torch.tensor(r["vel_in"]), True,
            torch.tensor(slot, dtype=torch.int32))
        return convert.to_numpy(m), convert.to_numpy(f), fl.numpy()
    if stage == "insert":
        m, f = TT.insert_keyframe(ts.cam, ts.track_cfg, T(r["map_in"], "cpu"),
                                  Fr(r["frame_in"], "cpu"), case["frame_id"],
                                  case["timestamp"], ref_kf, slot)
        return convert.to_numpy(m), convert.to_numpy(f), None
    st, mc = T(r["map_in"], "cpu"), ts.map_cfg
    if stage == "cull":
        st, n = TLM.cull_map_points(mc, st, slot)
    elif stage == "triangulate":
        st, n = TLM.triangulate_with_neighbors(ts.cam, mc, st, slot)
    elif stage == "fuse":
        st, n, _ = TLM.fuse_neighbors(ts.cam, mc, st, slot)
    elif stage == "refresh":
        st, n = TLM.refresh_landmarks(mc, st, slot), 0
    elif stage == "local_ba":
        st, _, n = TLM.local_ba(ts.cam, mc, st, slot)
    else:
        st, n = TLM.cull_keyframes(mc, st, slot)
    return convert.to_numpy(st), np.asarray(n)


def _rotation(q) -> np.ndarray:
    """(..., 3, 3) rotation of unit quaternions (..., 4) w, x, y, z."""
    w, x, y, z = (np.asarray(q, np.float64)[..., i] for i in range(4))
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def centres(pose7) -> np.ndarray:
    """Camera centres (..., 3) of pose7 rows (unit quaternion w, x, y, z of
    Rcw, then tcw), in float64."""
    p = np.asarray(pose7, np.float64)
    return -np.einsum("...ji,...j->...i", _rotation(p[..., :4]), p[..., 4:])


def keyframe_moves(before: dict, after: dict) -> np.ndarray:
    """How far (m) each keyframe live in both maps moved, slot 0 first."""
    live = before["kf_valid"] & after["kf_valid"]
    return np.linalg.norm(centres(after["kf_pose7"])[live]
                          - centres(before["kf_pose7"])[live], axis=1)


def hold_maps(t: dict, j: dict):
    """`test_mapping_pass_matches`'s tolerances: integer fields equal,
    live keyframe poses to MAP_POSE_ATOL, live landmarks' median to
    MAP_XYZ_MEDIAN_ATOL and every coordinate to MAP_XYZ_MAX_ATOL."""
    for name in j:
        if j[name].dtype.kind != "f":
            np.testing.assert_array_equal(t[name], j[name], err_msg=name)
    k, v = j["kf_valid"], j["lm_valid"]
    np.testing.assert_allclose(t["kf_pose7"][k], j["kf_pose7"][k],
                               atol=MAP_POSE_ATOL)
    dxyz = np.abs(t["lm_xyz"][v] - j["lm_xyz"][v])
    assert np.median(dxyz) <= MAP_XYZ_MEDIAN_ATOL, np.median(dxyz)
    assert dxyz.max() <= MAP_XYZ_MAX_ATOL, dxyz.max()


def step_91(ref: dict) -> float:
    """Camera-centre step (m) from frame 90's tracked pose to frame 91's."""
    return float(np.linalg.norm(
        centres(ref["track_next"]["frame"]["pose7"])
        - centres(ref["track"]["frame"]["pose7"])))


# ------------------------------------------------------------------ tests

@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return load_case(tmp_path_factory.mktemp("euroc_stereo"))


@pytest.fixture(scope="module")
def ref(case):
    return reference_chain(case)


def test_fixture_is_the_state_before_the_slide(case):
    """Slot 0 and 12 more keyframes live, the frame-90 keyframe's slot
    free, slot 0 sharing landmarks with the rest of the map."""
    m = case["map"]
    assert m["kf_valid"].sum() == 13 and m["kf_valid"][0]
    assert not m["kf_valid"][4]
    pts0 = m["kf_kp_point"][0][(m["kf_kp_point"][0] >= 0)
                               & m["kf_kp_valid"][0]]
    assert len(pts0) > 200 and m["lm_valid"][pts0].all()
    assert FIXTURE.stat().st_size < 2 * 2 ** 20


@pytest.mark.parametrize("stage", ["track", "insert", *STAGES,
                                   "track_next"])
def test_stage_matches_reference(case, ref, stage):
    """Each stage of frame 90's step and frame 91's tracking, fed the
    reference's input to it."""
    got = port_stage(case, stage, ref)
    want = ref[stage]
    hold_maps(got[0], want["map"])
    if stage in ("track", "track_next"):
        np.testing.assert_array_equal(got[2], want["flags"])
        np.testing.assert_array_equal(got[1]["point_ids"],
                                      want["frame"]["point_ids"])
        np.testing.assert_allclose(got[1]["pose7"], want["frame"]["pose7"],
                                   atol=MAP_POSE_ATOL)
    elif stage == "insert":
        assert want["slot"] == 4
        np.testing.assert_array_equal(got[1]["point_ids"],
                                      want["frame"]["point_ids"])
    else:
        np.testing.assert_array_equal(np.asarray(got[1]), want["count"])


def test_local_ba_slides_the_map_in_both(case, ref):
    """The keyframe-90 pass's local BA moves every live keyframe but slot 0
    by about 40 mm in both packages, and on 1-ulp moved inputs in the
    reference too: the slide belongs to the map, not to rounding."""
    r = ref["local_ba"]
    port, _ = port_stage(case, "local_ba", ref)
    slot = ref["insert"]["slot"]
    runs = {"reference": (r["map_in"], r["map"]),
            "port": (r["map_in"], port)}
    for seed in (1, 2):
        rng = np.random.RandomState(seed)
        moved = dict(r["map_in"], lm_xyz=ulp_moved(r["map_in"]["lm_xyz"], rng),
                     kf_pose7=ulp_moved(r["map_in"]["kf_pose7"], rng))
        st, _, _ = JLM.local_ba(case["jsys"].cam, case["jsys"].map_cfg,
                                _J(JMap, moved), jnp.int32(slot))
        runs[f"reference, ulp seed {seed}"] = (moved, _np(st))
    for name, (before, after) in runs.items():
        mv = keyframe_moves(before, after)
        assert mv[0] == 0.0, name                    # the gauge
        assert SLIDE_MM[0] < 1e3 * mv[1:].min(), (name, mv)
        assert 1e3 * mv[1:].max() < SLIDE_MM[1], (name, mv)
    np.testing.assert_allclose(keyframe_moves(r["map_in"], port),
                               keyframe_moves(r["map_in"], r["map"]),
                               atol=MAP_POSE_ATOL)


def test_step_at_frame_91_inside_reference_spread(case, ref):
    """The port chained on its own from the fixture (its frame 90 step and
    mapping pass, then frame 91) steps from frame 90 to 91 as the
    reference does on 1-ulp moved inputs."""
    ts = case["tsys"]
    T = convert.map_state_from_numpy
    Fr = convert.frame_from_numpy
    ref_kf = torch.tensor(max(case["ref_kf"], 0), dtype=torch.int32)
    m1, f1, vel, _ = TT.track_frame_fused(
        ts.cam, ts.track_cfg, T(case["map"], "cpu"),
        Fr(case["frame"], "cpu"), Fr(case["last"], "cpu"),
        torch.from_numpy(case["vel7"]), case["vel_ok"], ref_kf)
    slot = int(m1.free_kf_slot())
    st, fr = TT.insert_keyframe(ts.cam, ts.track_cfg, m1, f1,
                                case["frame_id"], case["timestamp"],
                                ref_kf, slot)
    st, _ = TLM.mapping_pass(ts.cam, ts.map_cfg, st, slot)
    _, f2, _, flags = TT.track_frame_fused(
        ts.cam, ts.track_cfg, st, Fr(case["next"], "cpu"), fr, vel, True,
        torch.tensor(slot, dtype=torch.int32))
    assert flags[0] == 1
    step = float(np.linalg.norm(centres(f2.pose7.numpy())
                                - centres(f1.pose7.numpy())))
    lo, hi = REF_STEP_91
    assert lo - MAP_POSE_ATOL <= step <= hi + MAP_POSE_ATOL, (step,
                                                              REF_STEP_91)
    # the frame after the slide steps with the map: over twice ground
    # truth's step
    assert step > 2 * GT_STEP_91
    assert abs(step_91(ref) - step) <= MAP_POSE_ATOL


# ------------------------------------------------------------ script modes

def spread_main(seeds):
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        case = load_case(Path(tmp))
        for seed in [-1, *seeds]:
            m, frame = case["map"], case["frame"]
            if seed >= 0:
                rng = np.random.RandomState(seed)
                m = dict(m, lm_xyz=ulp_moved(m["lm_xyz"], rng),
                         kf_pose7=ulp_moved(m["kf_pose7"], rng))
                frame = dict(frame, uvr=ulp_moved(frame["uvr"], rng))
            r = reference_chain(case, m, frame)
            before = r["local_ba"]["map_in"]
            mv = keyframe_moves(before, r["local_ba"]["map"])
            slot = r["insert"]["slot"]
            covis = convert.map_state_from_numpy(
                before, "cpu").covisibility_row(slot).numpy()
            pts0 = before["kf_kp_point"][0]
            print(json.dumps(dict(
                seed=seed, slot=slot,
                live_keyframes=int(before["kf_valid"].sum()),
                covisible_15=int((covis >= 15).sum()),
                slot0_landmarks=int(((pts0 >= 0)
                                     & before["kf_kp_valid"][0]).sum()),
                ba_moves_mm=[round(1e3 * float(x), 2) for x in mv],
                step_91_m=round(step_91(r), 6),
                flags_91=r["track_next"]["flags"].tolist())), flush=True)


def per_frame_errors(traj: Path, gt: Path, fps: float = 20.0,
                     fit_frames: int = 80):
    """(frame index, error m) of a TUM trajectory against ground truth,
    aligned (SE3) on the frames before `fit_frames`, and the SE3 ATE over
    all frames."""
    ts, c, _ = load_tum(traj)
    _, g, _ = load_tum(gt)
    k = np.rint(ts * fps).astype(int)
    fit = k < fit_frames
    _, R, t = umeyama_alignment(c[fit], g[k][fit], with_scale=False)
    err = np.linalg.norm(c @ R.T + t - g[k], axis=1)
    return k, err, ate_rmse(c, g[k], with_scale=False)


def anchored_errors(traj: Path, gt: Path, fps: float = 20.0):
    """(frame index, (N, 3) error m) of a TUM trajectory against ground
    truth in frame 0's camera coordinates, with no fitted alignment: the
    estimate starts at frame 0's pose."""
    ts, c, _ = load_tum(traj)
    _, g, q = load_tum(gt)
    k = np.rint(ts * fps).astype(int)
    return k, c - (g[k] - g[0]) @ _rotation(q[0])


def perframe_main(gt: Path, trajs):
    for traj in trajs:
        k, err, ate = per_frame_errors(Path(traj), gt)
        ka, ea = anchored_errors(Path(traj), gt)
        print(json.dumps(dict(
            trajectory=str(traj), frame_ate_m=round(ate, 4),
            err_mm_76_100={int(i): round(1e3 * float(e), 1)
                           for i, e in zip(k, err) if 76 <= i <= 100},
            max_err_mm_after_100=round(1e3 * float(err[k > 100].max()), 1),
            anchored_err_mm={int(i): [round(1e3 * float(v), 1) for v in e]
                             for i, e in zip(ka, ea)
                             if i in (1, 2, 3, 4, 5, 6, 10, 20, 40, 80, 89,
                                      91, 100, 119)})))


def full_entry(package: str, seed: int, data_dir: Path, out: Path,
               threads: int):
    """One 120-frame run of `package`'s stereo_euroc: trajectories and a
    per-frame log (inserted, keyframe moves) to `out`."""
    from orb_slam2_e_tpu_torch.tools import run_proxy_eval as rpe
    torch.set_num_threads(threads)
    d = data_dir / "proxy_euroc"
    argv, _ = rpe.example_args("euroc", "stereo", d)
    out.mkdir(parents=True, exist_ok=True)
    log = open(out / "steps.jsonl", "w")
    rng = np.random.RandomState(seed) if seed >= 0 else None
    made = []
    if package == "jax":
        import runpy
        from orb_slam2_e_tpu.models import system as S
        init = S.SlamSystem.__init__

        def keep(self, *a, **kw):
            init(self, *a, **kw)
            made.append(self)
            step = self._sstep[S.Sensor.STEREO]

            def logged(loop, *args):
                before = _np(loop.map)
                lo, flags, pose = step(loop, *args)
                log.write(json.dumps(_step_record(
                    int(args[2]), before, _np(lo.map),
                    np.asarray(flags))) + "\n")
                log.flush()
                return lo, flags, pose
            self._sstep[S.Sensor.STEREO] = logged
        S.SlamSystem.__init__ = keep
        track = S.SlamSystem.track_stereo
    else:
        from orb_slam2_e_tpu_torch.examples import stereo_euroc
        S = TS
        step = S.SlamSystem._super

        def logged(self, loop, frame, frame_id, *args):
            if not made:
                made.append(self)
            before = convert.to_numpy(loop.map)
            lo, flags, pose = step(self, loop, frame, frame_id, *args)
            log.write(json.dumps(_step_record(
                frame_id, before, convert.to_numpy(lo.map),
                flags.numpy())) + "\n")
            log.flush()
            return lo, flags, pose
        S.SlamSystem._super = logged
        track = S.SlamSystem.track_stereo

    def moved_track(self, im_l, im_r, t):
        if rng is not None:
            im_l, im_r = (ulp_moved(np.asarray(x, np.float32), rng)
                          for x in (im_l, im_r))
            if package == "torch":
                im_l, im_r = torch.from_numpy(im_l), torch.from_numpy(im_r)
        return track(self, im_l, im_r, t)
    S.SlamSystem.track_stereo = moved_track
    work = out / "work"
    work.mkdir(exist_ok=True)
    os.chdir(work)
    t0 = time.perf_counter()
    if package == "jax":
        sys.argv = ["stereo_euroc.py", *map(str, argv)]
        runpy.run_path(str(REPO / "examples" / "stereo_euroc.py"),
                       run_name="__main__")
    else:
        stereo_euroc.main([*map(str, argv), "--device", "cpu"])
    sysm, = made
    sysm.save_trajectory_tum(str(out / "FrameTrajectory.txt"))
    print(f"{package} seed {seed}: {time.perf_counter() - t0:.0f} s")


def _step_record(fid, before, after, flags) -> dict:
    mv = keyframe_moves(before, after)
    return dict(fid=fid, inserted=bool(flags[-1]),
                kf_moved_mm_median=round(1e3 * float(np.median(mv[1:])), 2)
                if len(mv) > 1 else 0.0,
                kf_moved_mm_max=round(1e3 * float(mv.max()), 2))


def full_main(args):
    data_dir, out = Path(args.data_dir).resolve(), Path(args.out_dir).resolve()
    from orb_slam2_e_tpu_torch.tools import run_proxy_eval as rpe
    rpe.ensure_stereo_sequence("euroc", argparse.Namespace(
        frames=120, device="cpu", data_dir=str(data_dir)))
    seeds = [int(s) for s in args.seeds.split(",")]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    pending, running = list(seeds), []
    while pending or running:
        while pending and len(running) < args.jobs:
            seed = pending.pop(0)
            run_dir = out / f"{args.package}_seed{seed}"
            run_dir.mkdir(parents=True, exist_ok=True)
            running.append(subprocess.Popen(
                [sys.executable, __file__, "full-entry", args.package,
                 str(seed), str(data_dir), str(run_dir), str(args.threads)],
                stdout=open(run_dir / "log.txt", "w"),
                stderr=subprocess.STDOUT, env=env))
        for p in list(running):
            if p.poll() is not None:
                running.remove(p)
        time.sleep(2)
    gt = data_dir / "proxy_euroc" / "groundtruth_tum.txt"
    for seed in seeds:
        run_dir = out / f"{args.package}_seed{seed}"
        k, err, ate = per_frame_errors(run_dir / "FrameTrajectory.txt", gt)
        steps = [json.loads(x) for x in open(run_dir / "steps.jsonl")]
        slides = [(s["fid"], s["kf_moved_mm_median"], s["kf_moved_mm_max"])
                  for s in steps if s["kf_moved_mm_median"] > 20.0]
        print(json.dumps(dict(
            package=args.package, seed=seed, threads=args.threads,
            frame_ate_m=round(ate, 4),
            slides_fid_median_max_mm=slides,
            err_mm_76_100={int(i): round(1e3 * float(e), 1)
                           for i, e in zip(k, err) if 76 <= i <= 100},
            max_err_mm_after_100=round(1e3 * float(err[k > 100].max()), 1))))


if __name__ == "__main__":
    mode = sys.argv[1:2]
    if mode == ["fixture"]:
        make_fixture(Path(sys.argv[2]).resolve())
    elif mode == ["spread"]:
        ap = argparse.ArgumentParser(prog="test_torch_euroc_stereo.py spread")
        ap.add_argument("--seeds", default="1,2,3")
        a = ap.parse_args(sys.argv[2:])
        spread_main([int(s) for s in a.seeds.split(",")])
    elif mode == ["full"]:
        ap = argparse.ArgumentParser(prog="test_torch_euroc_stereo.py full")
        ap.add_argument("data_dir")
        ap.add_argument("out_dir")
        ap.add_argument("--package", default="jax", choices=("jax", "torch"))
        ap.add_argument("--seeds", default="-1,1,2,3")
        ap.add_argument("--threads", type=int, default=FIXTURE_THREADS,
                        help="torch threads of a port run")
        ap.add_argument("--jobs", type=int, default=3)
        full_main(ap.parse_args(sys.argv[2:]))
    elif mode == ["perframe"]:
        perframe_main(Path(sys.argv[2]), sys.argv[3:])
    elif mode == ["full-entry"]:
        package, seed, data_dir, out, threads = sys.argv[2:7]
        full_entry(package, int(seed), Path(data_dir), Path(out),
                   int(threads))
    else:
        sys.exit(__doc__)
