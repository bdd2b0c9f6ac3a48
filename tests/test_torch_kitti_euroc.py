"""The port's KITTI and EuRoC entry points on the proxies of
`orb_slam2_e_tpu_torch/tools` (`make_proxy_kitti`: 640x256 stereo;
`make_proxy_euroc`: raw distorted 512x384 stereo with the LEFT./RIGHT.
blocks), on the CPU, beside the reference on the same files.

The sequences are generated by the port's twin generators at their full
widths and 6 frames (the original EuRoC generator cannot run; the twins'
frames are the originals' bit for bit on the CPU). The tests hold the
port's rectified pair against the reference's on one raw EuRoC pair, run
`run_proxy_eval` on both proxies (keys, files, gates), hold the stereo
examples' trajectories against the reference examples' on the same files,
and check that the runner's TUM defaults are unchanged.

    python tests/test_torch_kitti_euroc.py ref DATA_DIR OUT_DIR
        [--frames 120] [--entries stereo_kitti,mono_kitti,...] [--jobs 5]

runs the JAX package's five example programs (`stereo_kitti`,
`mono_kitti`, `stereo_euroc`, `mono_euroc`, `stream_mono`) on the CPU on
the proxies under DATA_DIR (generated there by the twin generators where
absent), scores them as the port's runner scores its own and writes
OUT_DIR/PROXY_RESULTS.json and the trajectories: the reference's results
that PERF.md, `run_proxy_eval --ref` and chip_smoke's KITTI / EuRoC phase
hold the port to.
"""

import argparse
import contextlib
import io
import json
import os
import runpy
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
sys.path[:0] = [str(HERE), str(REPO)]

import _torch_port  # noqa: E402  (thread settings)
from _torch_examples import _centres_tum, _hold_trajectories  # noqa: E402
from orb_slam2_e_tpu_torch.tools import (  # noqa: E402
    make_proxy_dataset, make_proxy_euroc, make_proxy_kitti)
from orb_slam2_e_tpu_torch.tools import run_proxy_eval as rpe  # noqa: E402
from orb_slam2_e_tpu_torch.tools.proxy_render import TEXTURES  # noqa: E402
from orb_slam2_e_tpu_torch.utils import config, datasets  # noqa: E402

# the reference's examples, by the runner's entry key
REF_SCRIPTS = {"stereo_kitti": "stereo_kitti.py",
               "mono_kitti": "mono_kitti.py",
               "stereo_euroc": "stereo_euroc.py",
               "mono_euroc": "mono_euroc.py",
               "stream_euroc": "stream_mono.py"}
# ... and on the TUM proxy xyz (`--entries rgbd_xyz,mono_xyz`: chip_smoke's
# PROXY_REF), scored as the runner's run_rgbd / run_mono score the port's
TUM_SCRIPTS = {"rgbd_xyz": "rgbd_tum.py", "mono_xyz": "mono_tum.py"}


def run_reference_entry(key: str, data_dir: Path, out_dir: Path,
                        frames: int) -> dict:
    """The reference's example of `key` on the proxy under `data_dir`,
    unmodified, through `runpy` in a working directory of its own; its
    files and the trajectories of its system go to `out_dir`. Returns the
    entry as the port's runner scores it."""
    from orb_slam2_e_tpu.models import system as ref_system
    sensor, seq = key.split("_")
    d = data_dir / f"proxy_{seq}"
    script = {**REF_SCRIPTS, **TUM_SCRIPTS}[key]
    if seq == "xyz":
        argv, stdin = [d / "settings.yaml", d, d / (
            "associations.txt" if sensor == "rgbd"
            else "KeyFrameTrajectory.txt")], None
    else:
        argv, stdin = rpe.example_args(seq, sensor, d)
    made = []
    init = ref_system.SlamSystem.__init__

    def keep(self, *args, **kwargs):
        made.append(self)
        init(self, *args, **kwargs)
    ref_system.SlamSystem.__init__ = keep
    out_dir.mkdir(parents=True, exist_ok=True)
    out = io.StringIO()
    saved_argv = sys.argv
    try:
        with rpe.working_dir(out_dir) as work, rpe.stdin_text(stdin), \
                contextlib.redirect_stdout(out):
            sys.argv = [script, *map(str, argv)]
            t0 = time.perf_counter()
            runpy.run_path(str(REPO / "examples" / script),
                           run_name="__main__")
            seconds = time.perf_counter() - t0
            sysm, = made
            n = len(sysm.trajectory)
            fr, kf = rpe.collect_outputs(work, out_dir, key, sysm)
    finally:
        sys.argv = saved_argv
        ref_system.SlamSystem.__init__ = init
    if seq == "xyz":
        with_scale = sensor == "mono"
        ate, tracked, t_first = rpe.ate_vs_gt(fr, d / "groundtruth.txt",
                                              with_scale)
        res = dict(ate_rmse_frames_m=rpe._round(ate), frames_tracked=tracked,
                   total_frames=frames)
        if with_scale:
            res["initialized_at_frame"] = int(round(
                t_first * make_proxy_dataset.FPS))
        return dict(res, package="jax", device="cpu", frames=n,
                    data=json.loads((d / "proxy.json").read_text()))
    res = rpe.score_entry(seq, sensor, fr, kf, d / "groundtruth_tum.txt",
                          frames)
    res.update(misses=rpe.e2e_misses(sensor, res), loop=(
        "pipelined" if sysm.cfg.pipeline else "synchronous"),
        data=json.loads((d / "proxy.json").read_text()), device="cpu",
        package="jax", frames=n, seconds=round(seconds, 1),
        frames_per_s=round(n / seconds, 3),
        stdout=out.getvalue().splitlines())
    return res


def ref_main(argv):
    ap = argparse.ArgumentParser(prog="test_torch_kitti_euroc.py ref")
    ap.add_argument("data_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--entries", default=",".join(REF_SCRIPTS))
    ap.add_argument("--jobs", type=int, default=5,
                    help="entries run at once, each in a process of its own")
    args = ap.parse_args(argv)
    data_dir, out_dir = Path(args.data_dir).resolve(), Path(
        args.out_dir).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    gen = argparse.Namespace(frames=args.frames, device="cpu",
                             data_dir=str(data_dir))
    for seq in sorted({k.split("_")[1] for k in args.entries.split(",")}):
        if seq == "xyz":
            rpe.ensure_sequence(data_dir / "proxy_xyz", make_proxy_dataset, [
                "--seq", "xyz", "--frames", args.frames, "--device", "cpu"],
                {"frames": args.frames, "seq": "xyz", "seed": 0,
                 "textures": list(TEXTURES)})
        else:
            rpe.ensure_stereo_sequence(seq, gen)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    pending, running = list(args.entries.split(",")), []
    while pending or running:
        while pending and len(running) < args.jobs:
            key = pending.pop(0)
            log = open(out_dir / f"{key}.log", "w")
            running.append((key, log, subprocess.Popen(
                [sys.executable, __file__, "ref-entry", key, str(data_dir),
                 str(out_dir), str(args.frames)], stdout=log,
                stderr=subprocess.STDOUT, env=env)))
        for item in list(running):
            key, log, proc = item
            if proc.poll() is not None:
                log.close()
                running.remove(item)
                print(f"{key}: exit {proc.returncode}", flush=True)
        time.sleep(2)
    path = out_dir / "PROXY_RESULTS.json"
    results = json.loads(path.read_text()) if path.exists() else {}
    for key in args.entries.split(","):
        part = out_dir / f"{key}.json"
        if part.exists():
            results[key] = json.loads(part.read_text())
            part.unlink()
    path.write_text(json.dumps(results, indent=2) + "\n")
    print(json.dumps({k: {f: v.get(f) for f in (
        "ate_rmse_frames_m", "frames_tracked", "ate_rmse_keyframes_m",
        "n_keyframes", "initialized_at_frame", "misses", "frames_per_s")}
        for k, v in results.items()}, indent=1))


FRAMES = 6
# the port's remap against the reference's on the CPU: each output is a
# few float32 operations on grey levels below 256, whose ulp is 2^-16;
# XLA orders the lerps' terms otherwise (measured: 2 ulps on 14% of the
# pixels), so 4 ulps
RECT_ATOL = 2.0 ** -14
ENTRIES = {"kitti": ["stereo_kitti", "mono_kitti"],
           "euroc": ["stereo_euroc", "mono_euroc", "stream_euroc"]}
REF_ENTRIES = "stereo_kitti,stereo_euroc"
ENTRY_KEYS = {"example", "ate_rmse_frames_m", "frames_tracked",
              "ate_rmse_keyframes_m", "n_keyframes", "total_frames",
              "alignment", "loop", "seed", "stage_ms", "stage_calls",
              "gate", "png_decoder", "decode_ms_per_frame", "device",
              "textures", "frames", "package", "seconds", "frames_per_s"}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Both proxies at FRAMES frames, generated by the twins on the CPU;
    the reference's stereo examples start on them at once, in processes
    of their own (`ref`), while the port runs."""
    root = tmp_path_factory.mktemp("kitti_euroc")
    gen = argparse.Namespace(frames=FRAMES, device="cpu",
                             data_dir=str(root / "data"))
    for seq in ENTRIES:
        rpe.ensure_stereo_sequence(seq, gen)
    log = open(root / "ref.log", "w")
    proc = subprocess.Popen(
        [sys.executable, __file__, "ref", str(root / "data"),
         str(root / "ref"), "--frames", str(FRAMES), "--entries",
         REF_ENTRIES, "--jobs", "2"], stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    yield root, proc
    if proc.poll() is None:
        proc.kill()
    proc.wait()
    log.close()


@pytest.fixture(scope="module")
def port_run(data):
    """run_proxy_eval on both proxies, on the CPU, with the stage timer:
    (output directory, results, the failed gates' message)."""
    root, _ = data
    out = root / "eval"
    try:
        rpe.main(["--seqs", "kitti,euroc", "--sensors", "mono,stereo,stream",
                  "--frames", str(FRAMES), "--device", "cpu", "--stage-ms",
                  "--data-dir", str(root / "data"), "--out-dir", str(out),
                  "--ref", str(root / "no_reference.json")])
        failed = ""
    except SystemExit as e:
        failed = str(e)
    return out, json.loads((out / "PROXY_RESULTS.json").read_text()), failed


@pytest.fixture(scope="module")
def reference(data):
    """The reference's stereo examples on the same files (`ref`)."""
    root, proc = data
    assert proc.wait(timeout=600) == 0, (root / "ref.log").read_text()
    return root / "ref", json.loads(
        (root / "ref" / "PROXY_RESULTS.json").read_text())


def test_rectified_pair_equals_the_reference(data):
    """One raw EuRoC proxy pair through both packages' rectifiers, built
    from the proxy's LEFT./RIGHT. blocks: the maps equal, the pairs within
    RECT_ATOL, out-of-range pixels (0) in the same places."""
    from orb_slam2_e_tpu.utils import config as jax_config
    root, _ = data
    d = root / "data" / "proxy_euroc"
    port = config.stereo_rectifier_from_settings(d / "settings.yaml",
                                                 device="cpu")
    ref = jax_config.stereo_rectifier_from_settings(d / "settings.yaml")
    for a, b in ((port.map_l, ref.map_l), (port.map_r, ref.map_r)):
        np.testing.assert_array_equal(_torch_port.tnp(a), np.asarray(b))
    _, lefts = datasets.load_euroc(d)
    raw = [datasets.read_gray(p) for p in (
        lefts[FRAMES // 2], lefts[FRAMES // 2].replace("/cam0/", "/cam1/"))]
    for got, want in zip(port(*raw), ref(*raw)):
        got, want = _torch_port.tnp(got), np.asarray(want)
        assert got.shape == want.shape == (make_proxy_euroc.H,
                                           make_proxy_euroc.W)
        np.testing.assert_allclose(got, want, rtol=0, atol=RECT_ATOL)
        np.testing.assert_array_equal(got == 0, want == 0)
        assert 0 < (got == 0).mean() < 0.05    # the corners leave the frame


@pytest.mark.parametrize("seq", list(ENTRIES))
def test_runner_entries_files_and_gates(seq, port_run):
    """The runner's entries for one proxy: their keys, the files each
    writes, the gate each was held to, and the failures it reported."""
    out, results, failed = port_run
    for key in ENTRIES[seq]:
        r = results[key]
        sensor = key.split("_")[0]
        assert ENTRY_KEYS | ({"initialized_at_frame"} if sensor != "stereo"
                             else set()) == set(r), key
        assert r["example"] == rpe.EXAMPLES[seq][sensor]
        assert (r["device"], r["package"], r["loop"], r["total_frames"],
                r["frames"]) == ("cpu", "torch", "pipelined", FRAMES, FRAMES)
        assert r["alignment"] == ("SE3 (no scale)" if sensor == "stereo"
                                  else "Sim3")
        assert r["gate"].startswith("the e2e gate (no reference")
        # a frame tracked after the first went through the tracking stage
        assert {"extract"} | ({"track"} if r["frames_tracked"] > 1
                              else set()) <= set(r["stage_ms"])
        assert r["stage_calls"]["extract"] == FRAMES
        for name in (f"FrameTrajectory_{key}.txt",
                     f"KeyFrameTrajectory_{key}.txt"):
            assert (out / name).exists(), name
        misses = rpe.e2e_misses(sensor, r)
        assert all(f"{key}: {m}" in failed for m in misses), (key, failed)
        assert (f"{key}:" in failed) == bool(misses), (key, failed)
    if seq == "euroc":
        assert "rectify pair" in results["stereo_euroc"]["stage_ms"]
        assert results["stereo_euroc"]["stage_calls"]["rectify pair"] \
            == FRAMES
    kitti = out / "CameraTrajectory_stereo_kitti.txt"
    if seq == "kitti":                   # the example's own KITTI 3x4 rows
        rows = kitti.read_text().splitlines()
        assert len(rows) == results["stereo_kitti"]["frames_tracked"]
        assert all(len(ln.split()) == 12 for ln in rows)


@pytest.mark.parametrize("seq", list(ENTRIES))
def test_stereo_trajectory_equals_the_reference(seq, port_run, reference):
    """The stereo example of each proxy beside the reference's on the same
    files: every frame tracked by both, camera centres within the bounds
    of tests/_torch_examples.py, ATE within 2x of each other."""
    out, results, _ = port_run
    ref_dir, ref = reference
    key = f"stereo_{seq}"
    r, w = results[key], ref[key]
    assert r["frames_tracked"] == w["frames_tracked"] == FRAMES
    assert w["misses"] == [] and w["package"] == "jax"
    _hold_trajectories(_centres_tum(out / f"FrameTrajectory_{key}.txt"),
                       _centres_tum(ref_dir / f"FrameTrajectory_{key}.txt"))
    a, b = r["ate_rmse_frames_m"], w["ate_rmse_frames_m"]
    assert max(a, b) <= rpe.REF_ATE_FACTOR * min(a, b) + 1e-3, (a, b)


def _groundtruth(seq: str, n: int, path: Path) -> Path:
    """groundtruth_tum.txt of an n-frame proxy, as its generator writes it
    (the poses alone, no rendering)."""
    if seq == "kitti":
        poses, centers = make_proxy_kitti.forward_trajectory(n)
    else:
        poses, centers = make_proxy_dataset.trajectory("xyz", n)
    fps = rpe.STEREO_SEQS[seq][2]
    path.write_text("\n".join(
        make_proxy_dataset.gt_line(k / fps, centers[k],
                                   make_proxy_dataset.quat32(R.T))
        for k, (R, _) in enumerate(poses)) + "\n")
    return path


@pytest.mark.parametrize("results", ["torch", "torch/reference_cpu"])
def test_committed_results_rescore(results, tmp_path):
    """The KITTI / EuRoC entries committed under eval/ (the port's on the
    card, the reference's on the CPU) score to their own numbers from
    their own trajectory files; the reference's meet the e2e gates on
    those files, so the port's were held to them."""
    d = REPO / "eval" / results
    res = json.loads((d / "PROXY_RESULTS.json").read_text())
    for seq, keys in ENTRIES.items():
        n = res[keys[0]]["total_frames"]
        gt = _groundtruth(seq, n, tmp_path / f"gt_{seq}.txt")
        for key in keys:
            sensor = key.split("_")[0]
            got = rpe.score_entry(seq, sensor,
                                  d / f"FrameTrajectory_{key}.txt",
                                  d / f"KeyFrameTrajectory_{key}.txt", gt, n)
            assert {k: res[key][k] for k in got} == got, key
            if results == "torch":
                assert res[key]["gate"].startswith(
                    "the e2e gate, which the reference meets")
                assert res[key]["device"].startswith("NVIDIA")
            else:
                assert rpe.e2e_misses(sensor, res[key]) == []
                assert res[key]["data"]["frames"] == n == 120


def _res(sensor, tracked, ate, init=0, kf_ate=0.01, total=20):
    r = dict(frames_tracked=tracked, total_frames=total,
             ate_rmse_frames_m=ate, ate_rmse_keyframes_m=kf_ate)
    if sensor != "stereo":
        r["initialized_at_frame"] = init
    return r


@pytest.mark.parametrize("sensor, port, ref, rule, n_fails", [
    ("stereo", _res("stereo", 20, 0.01), None, "the e2e gate (no", 0),
    ("stereo", _res("stereo", 18, 0.01), None, "the e2e gate (no", 1),
    ("stereo", _res("stereo", 20, 0.09), _res("stereo", 20, 0.02),
     "the e2e gate, which", 1),
    ("stereo", _res("stereo", 20, 0.15), _res("stereo", 20, 0.09),
     "the reference's own", 0),
    ("stereo", _res("stereo", 20, 0.19), _res("stereo", 20, 0.09),
     "the reference's own", 1),
    ("mono", _res("mono", 5, None, init=None), _res("mono", 6, None,
                                                     init=None),
     "the reference's own", 0),
    ("mono", _res("mono", 3, 0.02, init=15), _res("mono", 6, 0.02, init=14),
     "the reference's own", 1),
    ("mono", _res("mono", 8, 0.05, init=3), _res("mono", 9, 0.03, init=4),
     "the e2e gate, which", 0),
    ("stream", _res("stream", 8, 0.05, init=3, kf_ate=0.2),
     _res("stream", 9, 0.03, init=4), "the e2e gate, which", 1),
])
def test_gate_rule(sensor, port, ref, rule, n_fails):
    """The e2e gate holds where the reference meets it on the same files
    (or where there is no reference result); else the reference's own
    result: tracked frames less one, ATE within 2x."""
    fails = rpe.gate_entry(sensor, port, ref)
    assert port["gate"].startswith(rule) and len(fails) == n_fails, (
        port["gate"], fails)


def test_tum_defaults_unchanged(tmp_path, monkeypatch):
    """Without --seqs / --sensors the runner runs the TUM proxies xyz and
    desk, each through mono_tum and rgbd_tum, as before, and writes their
    entries with the fields they had."""
    calls = []

    def fake(sensor):
        def run(d, gt, evald, seq, args, common):
            calls.append((sensor, seq, d.name, gt.name, args.frames,
                          common))
            return {"ate_rmse_frames_m": 0.0}, 2.0, 400, []
        return run
    monkeypatch.setattr(rpe, "ensure_sequence", lambda *a: calls.append(
        ("gen", a[0].name, a[3])))
    monkeypatch.setattr(rpe, "run_mono", fake("mono"))
    monkeypatch.setattr(rpe, "run_rgbd", fake("rgbd"))
    rpe.main(["--device", "cpu", "--out-dir", str(tmp_path),
              "--data-dir", str(tmp_path / "data")])
    common = ["--device", "cpu", "--seed", "0"]
    gen = {"frames": 400, "seed": 0, "textures": list(TEXTURES)}
    assert calls == [
        ("gen", "proxy_xyz", dict(gen, seq="xyz")),
        ("mono", "xyz", "proxy_xyz", "groundtruth.txt", 400, common),
        ("rgbd", "xyz", "proxy_xyz", "groundtruth.txt", 400, common),
        ("gen", "proxy_desk", dict(gen, seq="desk")),
        ("mono", "desk", "proxy_desk", "groundtruth.txt", 400, common),
        ("rgbd", "desk", "proxy_desk", "groundtruth.txt", 400, common)]
    res = json.loads((tmp_path / "PROXY_RESULTS.json").read_text())
    assert sorted(res) == ["mono_desk", "mono_xyz", "rgbd_desk", "rgbd_xyz"]
    assert set(res["mono_xyz"]) == {
        "ate_rmse_frames_m", "device", "textures", "frames", "package",
        "seconds", "frames_per_s"}
    assert (res["rgbd_desk"]["frames_per_s"], res["rgbd_desk"]["device"]) \
        == (200.0, "cpu")


if __name__ == "__main__":
    if sys.argv[1:2] == ["ref"]:
        ref_main(sys.argv[2:])
    elif sys.argv[1:2] == ["ref-entry"]:
        key, data_dir, out_dir, frames = sys.argv[2:6]
        res = run_reference_entry(key, Path(data_dir), Path(out_dir),
                                  int(frames))
        (Path(out_dir) / f"{key}.json").write_text(json.dumps(res, indent=2))
        print(json.dumps({k: v for k, v in res.items() if k != "stdout"}))
    else:
        sys.exit(__doc__)
