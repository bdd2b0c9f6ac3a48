"""The port's TUM monocular and streaming example programs on a sequence on
disk, on the CPU, beside the reference's (see _torch_examples.py on the
monocular initialization and the seed)."""

import os
import re

import pytest

from _torch_examples import (  # noqa: F401  (the fixture is used by name)
    MONO, MONO_N, MONO_SEED, _centres_tum, _dirs, _hold_trajectories, _line,
    _run_port, _run_ref, _same_lines, _settings, tum_mono_seq)
from orb_slam2_e_tpu_torch.examples import mono_tum, stream_mono


def test_mono_tum_example(tmp_path, tum_mono_seq, monkeypatch):
    port, ref = _dirs(tmp_path)
    settings = _settings(tmp_path / "settings.yaml", **MONO)
    out_p, _, sysm = _run_port(
        mono_tum, [settings, tum_mono_seq, port / "kf.txt", "--seed",
                   MONO_SEED], port, monkeypatch)
    out_r, _ = _run_ref("mono_tum.py", [settings, tum_mono_seq,
                                        ref / "kf.txt"], ref, monkeypatch)
    _same_lines(out_p, out_r.replace(str(ref), str(port)),
                exact=("Images in the sequence:", "trajectory saved to"),
                timed=("median tracking time:", "mean tracking time:"))
    assert _line(out_p, "Images") == f"Images in the sequence: {MONO_N}"
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref)) == [
        "FrameTrajectory.txt", "kf.txt"]
    got, want = (_centres_tum(d / "FrameTrajectory.txt")
                 for d in (port, ref))
    tracked = sum(p7 is not None for _, p7 in sysm.trajectory)
    assert len(got[0]) == tracked
    assert (len((port / "kf.txt").read_text().splitlines())
            == int(sysm.map.n_keyframes()))
    if len(got[0]) >= 6 and len(want[0]) >= 6:    # both initialized
        _hold_trajectories(got, want, with_scale=True)


@pytest.mark.parametrize("form", ["paths", "stamped"])
def test_stream_mono_example(tmp_path, tum_mono_seq, monkeypatch, form):
    """The stdin line protocol, one path per line or `<timestamp> <path>`."""
    port, ref = _dirs(tmp_path)
    settings = _settings(tmp_path / "settings.yaml", **MONO)
    paths = sorted((tum_mono_seq / "rgb").glob("*.png"))
    if form == "paths":
        feed = "\n".join(str(p) for p in paths) + "\n\n"
    else:
        feed = "".join(f"{100.0 + k / 30.0:.6f} {p}\n"
                       for k, p in enumerate(paths))
    out_p, err_p, sysm = _run_port(
        stream_mono, [settings, "--out-traj", port / "kf.txt", "--out-map",
                      port / "map.npz", "--seed", MONO_SEED], port,
        monkeypatch, stdin=feed)
    assert out_p == ""                        # the node reports on stderr
    runs = [(err_p, port)]
    if form == "paths":                       # the reference beside it
        out_r, err_r = _run_ref("stream_mono.py", [
            settings, "--out-traj", ref / "kf.txt", "--out-map",
            ref / "map.npz"], ref, monkeypatch, stdin=feed)
        assert out_r == ""
        assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
        runs.append((err_r, ref))
    for err, d in runs:
        lines = [ln for ln in err.splitlines()
                 if ln.startswith(("tracked", "trajectory saved"))]
        assert re.fullmatch(rf"tracked {MONO_N} frames, \d+\.\d fps",
                            lines[0])
        assert lines[1] == f"trajectory saved to {d / 'kf.txt'}"
    assert sorted(os.listdir(port)) == ["kf.txt", "map.npz"]
    first_ts = sysm.trajectory[0][0]
    assert first_ts == (0.0 if form == "paths" else 100.0)
    assert len(sysm.trajectory) == MONO_N
    # localization-only mode from the command line
    _, _, loc = _run_port(stream_mono, [settings, "--localization"], port,
                          monkeypatch, stdin=f"{paths[0]}\n")
    assert loc.localization_only and len(loc.trajectory) == 1
    assert (port / "KeyFrameTrajectory.txt").exists()


