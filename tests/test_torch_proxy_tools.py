"""The port's proxy generators and evaluation runners
(`orb_slam2_e_tpu_torch/tools/make_proxy_*.py`, `run_proxy_eval.py`,
`run_endo_eval.py`) against the reference's tools on the CPU: ground truth,
settings texts, each generator's files, and each runner on a tiny sequence
(results written under a temporary directory, the repository's eval/ left
as it was). Tolerances: tests/_torch_proxy.py."""

import argparse
import functools
import hashlib
import json
import os
import sys

import numpy as np
import pytest

import _torch_port  # noqa: F401  (thread settings)
from _torch_proxy import (GT_LAST_DIGIT, GT_LINES_APART, POSE_DEPTH_COUNTS,
                          POSE_RENDER_MAX, POSE_RENDER_SHARE, REPO, gt_apart,
                          load_original)
from orb_slam2_e_tpu_torch.tools import make_proxy_dataset as tw_mpd
from orb_slam2_e_tpu_torch.tools import make_proxy_endo as tw_endo
from orb_slam2_e_tpu_torch.tools import make_proxy_euroc as tw_euroc
from orb_slam2_e_tpu_torch.tools import make_proxy_kitti as tw_kitti
from orb_slam2_e_tpu_torch.tools import proxy_render as pr
from orb_slam2_e_tpu_torch.tools import run_endo_eval, run_proxy_eval
from orb_slam2_e_tpu_torch.utils.imageio import write_png

cv2 = pytest.importorskip("cv2")


def _ref_gt_lines(poses, centers, fps):
    """The reference generators' ground-truth lines (lie.quat_from_mat in
    float32 under JAX)."""
    import jax.numpy as jnp
    from orb_slam2_e_tpu.ops import lie
    out = []
    for k, (R, _) in enumerate(poses):
        q = np.asarray(lie.quat_from_mat(jnp.asarray(R.T[None])))[0]
        c = centers[k]
        out.append(f"{k / fps:.6f} {c[0]:.7f} {c[1]:.7f} {c[2]:.7f} "
                   f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}")
    return out


@pytest.mark.parametrize("kind", ["xyz", "desk", "kitti", "euroc"])
def test_groundtruth_lines_equal_the_reference(kind):
    if kind == "kitti":
        ref, fps = load_original("make_proxy_kitti").forward_trajectory(20), 10.0
        twin = tw_kitti.forward_trajectory(20)
    else:
        seq = "xyz" if kind == "euroc" else kind
        fps = 20.0 if kind == "euroc" else 30.0
        ref = load_original("make_proxy_dataset").trajectory(seq, 20)
        twin = tw_mpd.trajectory(seq, 20)
    assert np.array_equal(ref[1], twin[1])             # centres: exact
    for (Ra, ta), (Rb, tb) in zip(ref[0], twin[0]):
        np.testing.assert_allclose(Rb, Ra, rtol=0, atol=1.2e-7)
        np.testing.assert_allclose(tb, ta, rtol=0, atol=1e-7)
    want = _ref_gt_lines(*ref, fps)
    got = [tw_mpd.gt_line(k / fps, c, tw_mpd.quat32(R.T))
           for k, ((R, _), c) in enumerate(zip(*twin))]
    n, worst = gt_apart(got, want)
    assert n <= GT_LINES_APART and worst <= GT_LAST_DIGIT, (n, worst)


def test_endo_trajectory_and_surface_equal_the_reference():
    ref = load_original("make_proxy_endo")
    for phase in ("map", "reloc"):
        (pa, ca), (pb, cb) = ref._trajectory(20, phase), \
            tw_endo._trajectory(20, phase)
        assert np.array_equal(ca, cb)
        assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                   for a, b in zip(pa, pb))
    for amp, t in ((0.0, 0.0), (0.12, 1.7)):
        assert np.array_equal(ref._surface_points(amp, t, 5),
                              tw_endo._surface_points(amp, t, 5))


def test_settings_texts_equal_the_reference():
    from test_torch_config import _tool_settings
    texts = _tool_settings()
    assert texts["make_proxy_dataset.SETTINGS_YAML"] == tw_mpd.SETTINGS_YAML
    assert texts["make_proxy_kitti.SETTINGS_YAML"] == tw_kitti.SETTINGS_YAML
    assert texts["make_proxy_euroc.settings_yaml"] == \
        tw_euroc.settings_yaml()
    assert texts["make_proxy_euroc.settings_mono_yaml"] == \
        tw_euroc.settings_mono_yaml()
    assert texts["make_proxy_endo.SETTINGS"] == tw_endo.SETTINGS


# ---------------------------------------------------------------------------
# Each generator's main
# ---------------------------------------------------------------------------

def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


GENERATORS = {
    # name: (reference tool, twin, extra arguments, ground-truth file)
    "tum": ("make_proxy_dataset", tw_mpd, ["--seq", "desk"],
            "groundtruth.txt"),
    "kitti": ("make_proxy_kitti", tw_kitti, [], "groundtruth_tum.txt"),
    "euroc": ("make_proxy_euroc", tw_euroc, [], "groundtruth_tum.txt"),
    "endo": ("make_proxy_endo", tw_endo, ["--phase", "reloc"],
             "groundtruth.txt"),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generator_main_equals_the_reference(name, tmp_path, monkeypatch):
    tool, twin, extra, gt = GENERATORS[name]
    ref = load_original(tool)
    if name == "euroc":
        # the reference sizes its frames by the TUM defaults, not by its
        # rays, and fails on its own 512x384 rays: give it the size
        monkeypatch.setattr(ref, "render", functools.partial(
            ref.render, size=(tw_euroc.W, tw_euroc.H)))
    a, b = tmp_path / "ref", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", [tool, str(a), "--frames", "2",
                                      *extra])
    ref.main()
    twin.main([str(b), "--frames", "2", "--device", "cpu", "--textures",
               "hopper", *extra])
    assert _files(b) == sorted(_files(a) + ["proxy.json"])
    rec = json.loads((b / "proxy.json").read_text())
    assert rec["textures"] == ["hopper"] and rec["frames"] == 2
    for f in _files(a):
        if f.endswith(".png"):
            want = cv2.imread(str(a / f), cv2.IMREAD_UNCHANGED)
            got = cv2.imread(str(b / f), cv2.IMREAD_UNCHANGED)
            assert got.dtype == want.dtype and got.shape == want.shape, f
            # the poses may stand 1 ulp apart (tests/_torch_proxy.py)
            d = np.abs(got.astype(np.int32) - want.astype(np.int32))
            if got.dtype == np.uint8:
                assert int(d.max()) <= POSE_RENDER_MAX, f
                assert float((d > 0).mean()) <= POSE_RENDER_SHARE, f
            else:
                assert int(d.max()) <= POSE_DEPTH_COUNTS, f
        elif f == gt:
            n, worst = gt_apart((b / f).read_text().splitlines(),
                                (a / f).read_text().splitlines())
            assert n <= GT_LINES_APART and worst <= GT_LAST_DIGIT, (n, worst)
        else:
            assert (b / f).read_text() == (a / f).read_text(), f


# ---------------------------------------------------------------------------
# The runners, on tiny sequences
# ---------------------------------------------------------------------------

TINY = dict(size=(320, 240), intr=(258.65, 258.25, 159.3, 127.65))


def _tiny_settings(text, size, intr, n_features, n_levels):
    """A generator's settings text moved to a small camera."""
    fx, fy, cx, cy = intr
    keys = {"Camera.fx": fx, "Camera.fy": fy, "Camera.cx": cx,
            "Camera.cy": cy, "Camera.width": size[0],
            "Camera.height": size[1], "ORBextractor.nFeatures": n_features,
            "ORBextractor.nLevels": n_levels}
    out = []
    for line in text.splitlines():
        k = line.split(":")[0]
        out.append(f"{k}: {keys[k]}" if k in keys else line)
    return "\n".join(out) + "\n"


def _record(d, **kw):
    ns = argparse.Namespace(frames=kw.pop("frames"), seed=kw.pop("seed"),
                            textures=pr.TEXTURES, device="cpu")
    tw_mpd.write_record(d, ns, **kw)


def write_tiny_tum(d, frames):
    """proxy_xyz at 160x120 in make_proxy_dataset's layout, its proxy.json
    as the generator writes it (so the runner takes it as made)."""
    (d / "rgb").mkdir(parents=True)
    (d / "depth").mkdir()
    room = pr.build_room(0)
    poses, centers = tw_mpd.trajectory("xyz", frames)
    assoc, rgb, gt = [], [], []
    for k, (R, t) in enumerate(poses):
        ts = k / tw_mpd.FPS
        img, depth = pr.render(room, R, t, size=TINY["size"],
                               intrinsics=TINY["intr"], device="cpu")
        name = f"{ts:.6f}.png"
        write_png(d / "rgb" / name, img)
        write_png(d / "depth" / name, tw_mpd.depth_png(depth))
        rgb.append(f"{ts:.6f} rgb/{name}")
        assoc.append(f"{ts:.6f} rgb/{name} {ts:.6f} depth/{name}")
        gt.append(tw_mpd.gt_line(ts, centers[k], tw_mpd.quat32(R.T)))
    (d / "rgb.txt").write_text("\n".join(rgb) + "\n")
    (d / "associations.txt").write_text("\n".join(assoc) + "\n")
    (d / "groundtruth.txt").write_text("\n".join(gt) + "\n")
    (d / "settings.yaml").write_text(_tiny_settings(
        tw_mpd.SETTINGS_YAML, TINY["size"], TINY["intr"], 600, 3))
    _record(d, frames=frames, seed=0, generator="make_proxy_dataset",
            seq="xyz")


def _eval_hashes():
    out = {}
    for f in _files(os.path.join(REPO, "eval")):
        with open(os.path.join(REPO, "eval", f), "rb") as fh:
            out[f] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_run_proxy_eval_on_a_tiny_sequence(tmp_path, monkeypatch):
    before = _eval_hashes()
    write_tiny_tum(tmp_path / "data" / "proxy_xyz", 6)
    out = tmp_path / "eval" / "torch"
    monkeypatch.chdir(tmp_path)
    argv = ["--frames", "6", "--seqs", "xyz", "--sensors", "rgbd",
            "--device", "cpu", "--data-dir", str(tmp_path / "data"),
            "--out-dir", str(out)]
    run_proxy_eval.main(argv)
    res = json.loads((out / "PROXY_RESULTS.json").read_text())
    r = res["rgbd_xyz"]
    assert {"ate_rmse_frames_m", "frames_tracked", "total_frames",
            "alignment", "device", "textures", "frames",
            "package"} <= set(r)
    assert r["frames_tracked"] == r["total_frames"] == r["frames"] == 6
    assert r["ate_rmse_frames_m"] < run_proxy_eval.RGBD_ATE_MAX
    assert (r["device"], r["package"], r["alignment"]) == \
        ("cpu", "torch", "SE3 (no scale)")
    assert r["textures"] == list(pr.TEXTURES)
    assert sorted(os.listdir(out)) == [
        "CameraTrajectory_rgbd_xyz.txt", "KeyFrameTrajectory_rgbd_xyz.txt",
        "PROXY_RESULTS.json"]
    assert sorted(os.listdir(tmp_path)) == ["data", "eval"]
    # the sequence was taken as made: nothing was rendered again
    assert len(os.listdir(tmp_path / "data" / "proxy_xyz" / "rgb")) == 6

    # a gate that fails: the results are written, then the run ends
    monkeypatch.setattr(run_proxy_eval, "RGBD_ATE_MAX", 0.0)
    with pytest.raises(SystemExit, match="rgbd_xyz: SE3 ATE"):
        run_proxy_eval.main(argv)
    again = json.loads((out / "PROXY_RESULTS.json").read_text())
    timing = ("seconds", "frames_per_s")
    assert {k: v for k, v in again["rgbd_xyz"].items() if k not in timing} \
        == {k: v for k, v in r.items() if k not in timing}
    # mono: the keys, whether or not six frames initialize it
    try:
        run_proxy_eval.main([*argv[:5], "mono", *argv[6:]])
    except SystemExit as e:
        assert "mono_xyz" in str(e)
    m = json.loads((out / "PROXY_RESULTS.json").read_text())["mono_xyz"]
    assert {"ate_rmse_frames_m", "frames_tracked", "ate_rmse_keyframes_m",
            "n_keyframes", "total_frames", "alignment",
            "initialized_at_frame", "device", "textures", "frames",
            "package"} <= set(m) and m["alignment"] == "Sim3"
    assert _eval_hashes() == before


def test_run_endo_eval_on_a_tiny_sequence(tmp_path, monkeypatch):
    before = _eval_hashes()
    size, intr = (120, 90), (105.0, 105.0, 60.0, 45.0)
    tex = tw_endo._patch_textures(5)
    frames = 5
    for phase, amp in (("map", 0.0), ("reloc", 0.12)):
        d = tmp_path / "data" / f"proxy_endo_{phase}"
        (d / "rgb").mkdir(parents=True)
        poses, _ = tw_endo._trajectory(frames, phase)
        lines = []
        for k, (R, t) in enumerate(poses):
            ts = k / tw_endo.FPS
            planes = tw_endo._make_patches(
                tw_endo._surface_points(amp, ts, 5), tex)
            img, _ = pr.render(planes, R, t, near=tw_endo.NEAR,
                               far=tw_endo.FAR, size=size, intrinsics=intr,
                               device="cpu")
            write_png(d / "rgb" / f"{ts:.6f}.png", img)
            lines.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        (d / "rgb.txt").write_text("\n".join(lines) + "\n")
        (d / "settings.yaml").write_text(_tiny_settings(
            tw_endo.SETTINGS, size, intr, 300, 3))
        _record(d, frames=frames, seed=5, generator="make_proxy_endo",
                phase=phase, amp=amp)
    out = tmp_path / "eval" / "torch"
    monkeypatch.chdir(tmp_path)
    run_endo_eval.main(["--frames", str(frames), "--device", "cpu",
                        "--data-dir", str(tmp_path / "data"),
                        "--out-dir", str(out)])
    kpi = json.loads((out / "ENDO_KPI.json").read_text())
    assert {"tp", "fp", "fn", "precision", "recall", "amp", "frames",
            "device", "textures", "package", "map_frames_tracked",
            "map_keyframes", "map_landmarks", "map_kf_inserted",
            "map_kf_culled"} <= set(kpi)
    assert 0 <= kpi["map_frames_tracked"] <= frames
    assert (kpi["amp"], kpi["frames"], kpi["device"]) == (0.12, frames,
                                                         "cpu")
    assert sorted(os.listdir(out)) == ["ENDO_KPI.json",
                                       "StatsReloc_endo.txt"]
    assert (tmp_path / "data" / "proxy_endo_map" / "endo_map.npz").exists()
    build = (tmp_path / "data" / "proxy_endo_map" /
             "settings_build.yaml").read_text()
    assert "RelocParam.bTestAllFrames: 0" in build
    assert _eval_hashes() == before
