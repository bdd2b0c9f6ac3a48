"""The port's deformable monocular example example on a sequence on disk, on
the CPU: a map built and saved beside the reference's example, then the
relocalization KPI protocol on the stored map."""

import os
import re

from _torch_examples import (  # noqa: F401  (the fixture is used by name)
    MONO, MONO_SEED, _dirs, _line, _run_port, _run_ref, _same_lines,
    _settings, tum_mono_seq)
from orb_slam2_e_tpu_torch.examples import mono_deformable
from orb_slam2_e_tpu_torch.models.system import SlamSystem
from orb_slam2_e_tpu_torch.utils import map_io


KPI = re.compile(r"reloc KPI: TP=(\d+) FP=(\d+) FN=(\d+) "
                 r"precision=(\d\.\d{3}) recall=(\d\.\d{3})")


def test_mono_deformable_example(tmp_path, tum_mono_seq, monkeypatch):
    """Build and save a map, then load it and localize with every frame
    forced through relocalization (`RelocParam.bTestAllFrames: 1`)."""
    port, ref = _dirs(tmp_path)
    settings = _settings(tmp_path / "settings.yaml", **MONO)
    # the example saves the map before `shutdown()`; on the pipelined loop
    # the host's counters then run up to two frames behind the map, as in
    # the reference: the file holds the counters of that moment
    at_save = []
    save_map = SlamSystem.save_map

    def counted_save_map(self, path):
        at_save.append(self.n_keyframes)
        return save_map(self, path)
    monkeypatch.setattr(SlamSystem, "save_map", counted_save_map)
    out_p, _, sysm = _run_port(
        mono_deformable, [settings, tum_mono_seq, "--save-map",
                          port / "map.npz", "--seed", MONO_SEED], port,
        monkeypatch)
    out_r, _ = _run_ref("mono_deformable.py", [
        settings, tum_mono_seq, "--save-map", ref / "map.npz"], ref,
        monkeypatch)
    _same_lines(out_p, out_r)
    assert KPI.fullmatch(_line(out_p, "reloc KPI:"))
    assert KPI.fullmatch(_line(out_r, "reloc KPI:"))
    assert sysm.cfg.deformable and not sysm.localization_only
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref)) == [
        "KeyFrameTrajectory.txt", "map.npz"]
    back, extra = map_io.load_map(port / "map.npz", device="cpu")
    assert int(extra["n_keyframes"]) == at_save[0]
    monkeypatch.setattr(SlamSystem, "save_map", save_map)

    # the KPI protocol on the stored map
    kpi_settings = _settings(
        tmp_path / "kpi.yaml", **MONO,
        extra="RelocParam.bTestAllFrames: 1\nRelocParam.nElType: 2\n")
    out_l, _, loc = _run_port(
        mono_deformable, [kpi_settings, tum_mono_seq, "--load-map",
                          port / "map.npz", "--stats", port / "Stats.txt"],
        port, monkeypatch)
    tp, fp, fn = (int(v) for v in KPI.fullmatch(
        _line(out_l, "reloc KPI:")).groups()[:3])
    assert (tp, fp, fn) == (loc.kpi.tp, loc.kpi.fp, loc.kpi.fn)
    assert loc.localization_only and loc.cfg.reloc_test_all_frames
    assert loc.cfg.el_type == 2
    rows = (port / "Stats.txt").read_text().splitlines()
    assert rows[0].split("\t")[0] == "Frame"
    if int(loc.map.n_keyframes()) >= 2:     # a map to relocalize on
        assert len(rows) - 1 >= 1 and tp + fn >= 1
    # a directory of frames without rgb.txt: timestamps from Camera.fps
    few = tmp_path / "frames"
    few.mkdir()
    for p in sorted((tum_mono_seq / "rgb").glob("*.png"))[:3]:
        (few / p.name).write_bytes(p.read_bytes())
    out_g, _, short = _run_port(mono_deformable, [settings, few], port,
                                monkeypatch)
    assert _line(out_g, "Images") == "Images in the sequence: 3"
    assert [round(t * 30) for t, _ in short.trajectory] == [0, 1, 2]
