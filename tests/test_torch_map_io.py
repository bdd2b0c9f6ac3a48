"""The port's map save/load against the reference's (CPU): one npz format,
read and written by both packages, and a system that loads a map and
relocalizes its first frame."""

import numpy as np
import pytest
import torch

from _torch_port import as_jax, tnp
from orb_slam2_e_tpu.models.map_state import MapState as JMap
from orb_slam2_e_tpu.models.system import (SlamSystem as JSys,
                                           SystemConfig as JCfg,
                                           Sensor as JSensor,
                                           TrackState as JTrackState)
from orb_slam2_e_tpu.ops import camera as jcam
from orb_slam2_e_tpu.utils import map_io as jio
from orb_slam2_e_tpu_torch.models.map_state import MapState
from orb_slam2_e_tpu_torch.models.system import (SlamSystem, SystemConfig,
                                                 Sensor, TrackState)
from orb_slam2_e_tpu_torch.ops.camera import Camera
from orb_slam2_e_tpu_torch.utils import convert, map_io
from orb_slam2_e_tpu_torch.utils.synthetic import (SyntheticScene,
                                                   orbit_trajectory)

SCENE = dict(n_points=500, seed=2, width=480, height=360, fx=400, fy=400,
             cx=240, cy=180)
CAM = dict(fx=400, fy=400, cx=240, cy=180, bf=40.0, width=480, height=360)
CFG = dict(max_keyframes=16, max_points=4096, n_features=600, n_levels=4,
           max_frames_between_kf=3, pipeline=False, loop_closing=False)
N_FRAMES = 9
# a relocalized centre against ground truth (tests/test_torch_reloc.py)
CENTER_GT_ATOL = 0.05
# the farthest a landmark of the scene at rest moves in a non-rigid
# relocalization: measured 0.183 m (depth, 4-9 m away, is the loose
# direction of a point seen from three nearby views)
MOVED_AT_REST_MAX = 0.5


def _frames():
    scene = SyntheticScene(**SCENE)
    poses, centers = orbit_trajectory(n_frames=16, radius=0.9, forward=0.04)
    return [(scene.render(R, t), scene.depth_map(R, t))
            for R, t in poses[:N_FRAMES + 1]], centers


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """A port system after N_FRAMES RGB-D frames, its saved map, and the
    next frame with its true centre."""
    frames, centers = _frames()
    s = SlamSystem(Camera.create(**CAM), SystemConfig(**CFG), Sensor.RGBD,
                   device="cpu")
    for k, (img, depth) in enumerate(frames[:N_FRAMES]):
        assert s.track_rgbd(img, depth, k / 30.0) is not None
    path = tmp_path_factory.mktemp("map") / "port.npz"
    s.save_map(path)
    assert s.n_keyframes >= 3
    return s, path, frames[N_FRAMES], centers[N_FRAMES]


def _fields_equal(state, arrays, what):
    """A MapState of either package, or its numpy fields, against numpy
    fields: dtype, shape and every value."""
    if not isinstance(state, dict):
        state = state._asdict()
    for k in MapState._fields:
        got = np.asarray(state[k])
        assert got.dtype == arrays[k].dtype and got.shape == arrays[k].shape, \
            (what, k)
        np.testing.assert_array_equal(got, arrays[k], err_msg=f"{what} {k}")


def test_port_file_port_is_bit_for_bit(mapped):
    s, path, _, _ = mapped
    state, extra = map_io.load_map(path, device="cpu")
    for k, v in s.map._asdict().items():
        got = getattr(state, k)
        assert got.dtype == v.dtype and got.shape == v.shape, k
        assert torch.equal(got, v), k
    assert state.next_seq.dim() == 0 and state.lm_rigid.dtype == torch.int8
    assert int(extra["last_kf_slot"]) == s.last_kf_slot
    assert int(extra["n_keyframes"]) == s.n_keyframes
    assert int(extra["frame_id"]) == s.frame_id == N_FRAMES - 1
    # the vocabulary rides along, bit-packed
    assert extra["voc_nodes_packed"].dtype == np.uint8
    assert int(extra["voc_k"]) ** int(extra["voc_L"]) == s.vocab.n_words
    with np.load(path) as data:
        assert int(data["format_version"]) == map_io.FORMAT_VERSION == \
            jio.FORMAT_VERSION == 3
        assert sorted(k[4:] for k in data.files if k.startswith("map_")) == \
            sorted(MapState._fields)


def test_port_file_loads_in_the_reference(mapped):
    s, path, _, _ = mapped
    state, extra = jio.load_map(path)
    _fields_equal(state, convert.to_numpy(s.map), "port -> reference")
    _, extra_t = map_io.load_map(path, device="cpu")
    assert sorted(extra) == sorted(extra_t)
    for k in extra:
        np.testing.assert_array_equal(np.asarray(extra[k]), extra_t[k],
                                      err_msg=k)


def test_reference_file_loads_in_the_port(mapped, tmp_path):
    s, _, _, _ = mapped
    arrays = convert.to_numpy(s.map)
    extra = {"last_kf_slot": 3, "n_keyframes": 4, "frame_id": 8,
             "note": np.arange(5)}
    jio.save_map(tmp_path / "ref.npz", as_jax(JMap, arrays), extra=extra)
    state, extra_t = map_io.load_map(tmp_path / "ref.npz", device="cpu")
    _fields_equal(convert.to_numpy(state), arrays, "reference -> port")
    assert sorted(extra_t) == sorted(extra)
    for k, v in extra.items():
        np.testing.assert_array_equal(extra_t[k], np.asarray(v), err_msg=k)


def test_both_systems_load_the_other_packages_map(mapped, tmp_path):
    """`SlamSystem.save_map` / `load_map` across the packages: counters,
    state LOST, the vocabulary and the refilled recognition database."""
    s, path, _, _ = mapped
    sj = JSys(jcam.Camera.create(**CAM), JCfg(**CFG), JSensor.RGBD)
    sj.load_map(path)
    assert sj.state == JTrackState.LOST
    assert (sj.n_keyframes, sj.last_kf_slot, sj.frame_id) == \
        (s.n_keyframes, s.last_kf_slot, s.frame_id)
    _fields_equal(sj.map, convert.to_numpy(s.map), "system: port -> ref")
    sj.save_map(tmp_path / "ref.npz")
    st = SlamSystem(Camera.create(**CAM), SystemConfig(**CFG), Sensor.RGBD,
                    device="cpu")
    st.load_map(tmp_path / "ref.npz")
    assert st.state == TrackState.LOST
    assert (st.n_keyframes, st.last_kf_slot, st.frame_id) == \
        (s.n_keyframes, s.last_kf_slot, s.frame_id)
    for k, v in s.map._asdict().items():
        assert torch.equal(getattr(st.map, k), v), k
    assert torch.equal(st.vocab.node_bits, s.vocab.node_bits)
    assert torch.equal(st.vocab.idf, s.vocab.idf)
    # the database is refilled from the loaded keyframes, in both
    filled = tnp(st.bow_db.filled)
    np.testing.assert_array_equal(filled, tnp(s.map.kf_valid))
    np.testing.assert_array_equal(np.asarray(sj.bow_db.filled), filled)
    np.testing.assert_allclose(np.asarray(sj.bow_db.vecs)[filled],
                               tnp(st.bow_db.vecs)[filled], atol=1e-6)
    assert float(st.bow_db.vecs[filled].sum(1).min()) > 0.99


@pytest.mark.parametrize("deformable", [False, True])
def test_loaded_map_relocalizes_its_first_frame(mapped, deformable):
    """The workflow of the deformable mode: load a map, localization-only
    mode, and the first frame is relocalized against the map."""
    s, path, (img, depth), centre = mapped
    fresh = SlamSystem(Camera.create(**CAM),
                       SystemConfig(**CFG, deformable=deformable),
                       Sensor.RGBD, device="cpu")
    fresh.load_map(path)
    fresh.activate_localization_mode()
    assert fresh.last_frame is None and fresh.state == TrackState.LOST
    pose = fresh.track_rgbd(img, depth, N_FRAMES / 30.0)
    assert pose is not None and fresh.state == TrackState.OK
    assert fresh.frame_id == N_FRAMES and fresh.stats["relocs"] == 1
    R, t = (tnp(x).astype(np.float64) for x in pose)
    assert np.linalg.norm(-R.T @ t - centre) < CENTER_GT_ATOL
    moved = (fresh.map.lm_xyz - s.map.lm_xyz).norm(dim=1)
    if not deformable:
        # localization-only mode without the deformable mode: the map
        # comes out as it went in
        for k, v in s.map._asdict().items():
            assert torch.equal(getattr(fresh.map, k), v), k
        return
    # The decision table takes the non-rigid pose whenever that branch
    # reaches the bar, on a scene at rest too (the reference's rule): the
    # landmarks it tracked are flagged non-rigid and move by what the
    # noise of the frame's keypoints asks for, centimetres at most.
    flagged = fresh.map.lm_rigid == 2
    assert int(flagged.sum()) >= 50
    assert int((fresh.map.lm_rigid == 1).sum()) == 0
    assert float(moved[~flagged].max()) == 0.0
    assert 0.0 < float(moved.max()) < MOVED_AT_REST_MAX
    for k, v in s.map._asdict().items():
        if k not in ("lm_xyz", "lm_rigid"):
            assert torch.equal(getattr(fresh.map, k), v), k


def _rewrite(path, out, drop=(), **replace):
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files if k not in drop}
    arrays.update({k: np.asarray(v) for k, v in replace.items()})
    np.savez_compressed(out, **arrays)


def test_newer_version_is_refused(mapped, tmp_path):
    _rewrite(mapped[1], tmp_path / "v4.npz", format_version=4)
    with pytest.raises(ValueError, match="version 4"):
        map_io.load_map(tmp_path / "v4.npz", device="cpu")
    with pytest.raises(ValueError):
        jio.load_map(tmp_path / "v4.npz")


def test_missing_field_is_refused(mapped, tmp_path):
    _rewrite(mapped[1], tmp_path / "cut.npz", drop=("map_lm_desc",))
    with pytest.raises(ValueError, match="lm_desc"):
        map_io.load_map(tmp_path / "cut.npz", device="cpu")


@pytest.mark.parametrize("version", [1, 2])
def test_old_versions_migrate_as_in_the_reference(mapped, tmp_path, version):
    """v1 lacks kf_seq / next_seq / lm_first_seq, v1 and v2 lack lm_angle.
    The v1 backfill sets next_seq to the NUMBER of valid keyframes, which
    lies below the largest backfilled kf_seq + 1 once a slot has been
    culled: the reference's rule, reproduced (not repaired), so that both
    packages load an old file into the same state."""
    s, path, _, _ = mapped
    kf_valid = tnp(s.map.kf_valid).copy()
    kf_valid[1] = False                   # a culled slot below the last one
    drop = ["map_lm_angle"]
    if version == 1:
        drop += ["map_kf_seq", "map_next_seq", "map_lm_first_seq"]
    _rewrite(path, tmp_path / "old.npz", drop=drop, format_version=version,
             map_kf_valid=kf_valid)
    state, _ = map_io.load_map(tmp_path / "old.npz", device="cpu")
    want, _ = jio.load_map(tmp_path / "old.npz")
    _fields_equal(convert.to_numpy(state),
                  {k: np.asarray(v) for k, v in want._asdict().items()},
                  f"v{version}")
    assert not state.lm_angle.any()
    if version == 1:
        seq = tnp(state.kf_seq)
        np.testing.assert_array_equal(
            seq, np.where(kf_valid, np.arange(len(kf_valid)), -1))
        assert int(state.next_seq) == kf_valid.sum() < seq.max() + 1
        assert not state.lm_first_seq.any()


def test_export_pointcloud_txt(mapped, tmp_path):
    s, _, _, _ = mapped
    map_io.export_pointcloud_txt(tmp_path / "t.txt", s.map)
    jio.export_pointcloud_txt(tmp_path / "j.txt",
                              as_jax(JMap, convert.to_numpy(s.map)))
    text = (tmp_path / "t.txt").read_text()
    assert text == (tmp_path / "j.txt").read_text()
    assert len(text.splitlines()) == int(s.map.lm_valid.sum()) > 100
