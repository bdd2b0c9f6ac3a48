"""The port's settings reader against the reference's PyYAML loader: every
settings text the repository writes, plus hand-written cases, must parse to
the same raw dict (keys, Python types, matrices), the same `Settings` and
the same `SystemConfig.from_settings`."""

import ast
import dataclasses
import os

import numpy as np
import pytest

from orb_slam2_e_tpu.models import system as ref_system
from orb_slam2_e_tpu.utils import config as ref_config
from orb_slam2_e_tpu_torch.models import system as port_system
from orb_slam2_e_tpu_torch.utils import config as port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_dataset_drivers.py::_write_settings
FX, W, H, BF = 260.0, 320, 240, 31.2


def _dataset_settings(bf=None, nfeat=400, extra=""):
    s = f"""%YAML:1.0
Camera.fx: {FX}
Camera.fy: {FX}
Camera.cx: {W / 2}
Camera.cy: {H / 2}
Camera.fps: 30.0
Camera.width: {W}
Camera.height: {H}
"""
    if bf is not None:
        s += f"Camera.bf: {bf}\nThDepth: 40.0\n"
    s += f"""ORBextractor.nFeatures: {nfeat}
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 3
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""
    return s + extra


def _mat(name, arr, rows, cols):
    flat = ", ".join(f"{v:.6f}" for v in np.asarray(arr).ravel())
    return (f"{name}: !!opencv-matrix\n   rows: {rows}\n"
            f"   cols: {cols}\n   dt: d\n   data: [{flat}]\n")


def _rectifier_blocks():
    K = [FX, 0, W / 2, 0, FX, H / 2, 0, 0, 1]
    return (f"LEFT.width: {W}\nLEFT.height: {H}\n"
            f"RIGHT.width: {W}\nRIGHT.height: {H}\n"
            + _mat("LEFT.K", K, 3, 3) + _mat("LEFT.D", [0] * 5, 1, 5)
            + _mat("LEFT.R", np.eye(3), 3, 3)
            + _mat("LEFT.P", [FX, 0, W / 2, 0, 0, FX, H / 2, 0,
                              0, 0, 1, 0], 3, 4)
            + _mat("RIGHT.K", K, 3, 3) + _mat("RIGHT.D", [0] * 5, 1, 5)
            + _mat("RIGHT.R", np.eye(3), 3, 3)
            + _mat("RIGHT.P", [FX, 0, W / 2, -BF, 0, FX, H / 2, 0,
                               0, 0, 1, 0], 3, 4))


# tests/test_viewer_examples.py::test_mono_tum_driver
VIEWER_TEXT = """%YAML:1.0
Camera.fx: 260.0
Camera.fy: 260.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.fps: 30.0
Camera.width: 320
Camera.height: 240
ORBextractor.nFeatures: 300
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 3
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""

# tests/test_trajectory.py::test_settings_loader
TRAJECTORY_TEXT = """%YAML:1.0
Camera.fx: 517.3
Camera.fy: 516.5
Camera.cx: 318.6
Camera.cy: 255.3
Camera.k1: 0.26
Camera.k2: -0.95
Camera.p1: -0.005
Camera.p2: 0.002
Camera.k3: 1.16
Camera.fps: 30.0
Camera.RGB: 1
ORBextractor.nFeatures: 1200
ORBextractor.scaleFactor: 1.1
ORBextractor.nLevels: 6
ORBextractor.iniThFAST: 24
ORBextractor.minThFAST: 7
RelocParam.bTestAllFrames: 1
RelocParam.nPrecisionFrames: 3
RelocParam.nElType: 2
"""

HAND_WRITTEN = """%YAML:1.0
---
# a comment line

Camera.fx: 517.3   # a trailing comment
Camera.fy: 1.
Camera.cx: .5
Camera.k1: 1e-3
Camera.k2: -1.0e-3
Camera.p1: 1.5E+2
Camera.fps: 25
Camera.RGB: no
Camera.width: 1_280
Camera.height: +720
DepthMapFactor: 5000.0
RelocParam.bTestAllFrames: yes
RelocParam.bUseInverse: On
Output.StatsReloc: "out dir/Stats#Reloc.txt"
Viewer.KeyFrameSize: 0.05
Viewer.Title: 'it''s a map'
Viewer.Mode: follow camera
Viewer.Empty:
Viewer.Null: ~
LEFT.P: !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2, 0, 367.4, 0,
       0., 435.2, 252.2, 0,   # a comment inside the list

       0, 0, 1, -4.7e+1 ]
ThDepth: 35
"""


def _tool_settings():
    """The settings.yaml strings of the proxy-dataset generators, read out
    of the tools' source text (the tools are not imported: they import JAX
    and each other). Module-level constants and the three small functions
    that build the text are evaluated from the syntax tree."""
    out = {}
    for tool in ("make_proxy_dataset", "make_proxy_kitti",
                 "make_proxy_euroc", "make_proxy_endo"):
        with open(os.path.join(REPO, "tools", tool + ".py")) as f:
            tree = ast.parse(f.read())
        ns = {"np": np}
        wanted = ("_mat_yaml", "settings_yaml", "settings_mono_yaml")
        for node in tree.body:
            keep = (isinstance(node, ast.Assign)
                    or (isinstance(node, ast.FunctionDef)
                        and node.name in wanted))
            if not keep:
                continue
            try:
                exec(compile(ast.Module([node], []), tool, "exec"), ns)
            except Exception:
                pass          # a constant built from something not kept
        texts = {k: v for k, v in ns.items()
                 if isinstance(v, str) and v.startswith("%YAML")}
        texts.update({k: ns[k]() for k in wanted[1:] if k in ns})
        assert texts, tool
        for k, v in texts.items():
            out[f"{tool}.{k}"] = v
    return out


TEXTS = {
    "dataset_mono": _dataset_settings(),
    "dataset_bf": _dataset_settings(bf=BF),
    "dataset_rectifier": _dataset_settings(bf=BF, extra=_rectifier_blocks()),
    "viewer_examples": VIEWER_TEXT,
    "trajectory": TRAJECTORY_TEXT,
    "hand_written": HAND_WRITTEN,
    "empty": "%YAML:1.0\n",
    **_tool_settings(),
}


def _write(tmp_path, text):
    p = tmp_path / "settings.yaml"
    p.write_text(text)
    return p


def test_every_tool_text_was_found():
    names = set(TEXTS)
    assert {"make_proxy_dataset.SETTINGS_YAML", "make_proxy_kitti."
            "SETTINGS_YAML", "make_proxy_euroc.settings_yaml",
            "make_proxy_euroc.settings_mono_yaml",
            "make_proxy_endo.SETTINGS"} <= names, names


@pytest.mark.parametrize("name", list(TEXTS))
def test_raw_dict_equals_reference(tmp_path, name):
    p = _write(tmp_path, TEXTS[name])
    want, got = ref_config.load_raw(p), port_config.load_raw(p)
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape
            np.testing.assert_array_equal(got[k], v)
        else:
            assert type(got[k]) is type(v) and got[k] == v, k


@pytest.mark.parametrize("name", list(TEXTS))
def test_settings_equal_reference(tmp_path, name):
    p = _write(tmp_path, TEXTS[name])
    want = dataclasses.asdict(ref_config.load_settings(p))
    got = dataclasses.asdict(port_config.load_settings(p))
    assert got == want
    for k, v in want.items():
        assert type(got[k]) is type(v), k


@pytest.mark.parametrize("name", list(TEXTS))
def test_from_settings_equals_reference(tmp_path, name):
    p = _write(tmp_path, TEXTS[name])
    want = ref_system.SystemConfig.from_settings(ref_config.load_settings(p))
    got = port_system.SystemConfig.from_settings(
        port_config.load_settings(p), vocab_path=None)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("factor", [0, 1, 5000, 0.0002, "5000.0", "1e-3"])
def test_depth_map_factor_inversion(tmp_path, factor):
    p = _write(tmp_path, VIEWER_TEXT + f"DepthMapFactor: {factor}\n"
               "Camera.fps: 20.0\nOutput.StatsReloc: stats.txt\n")
    want = ref_system.SystemConfig.from_settings(
        ref_config.load_settings(p), vocab_path="v.npz")
    got = port_system.SystemConfig.from_settings(
        port_config.load_settings(p), vocab_path="v.npz")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.max_frames_between_kf == 20 and got.vocab_path == "v.npz"
    assert got.stats_reloc_path == "stats.txt"


def test_camera_from_settings(tmp_path):
    p = _write(tmp_path, TRAJECTORY_TEXT)
    want = ref_config.camera_from_settings(ref_config.load_settings(p))
    got = port_config.camera_from_settings(port_config.load_settings(p),
                                           device="cpu")
    for k, v in want._asdict().items():
        g = getattr(got, k)
        assert g.device.type == "cpu" and str(g.dtype) == "torch.float32"
        assert float(g) == float(v), k


def test_stereo_rectifier_from_settings(tmp_path):
    p = _write(tmp_path, TEXTS["dataset_rectifier"])
    want = ref_config.stereo_rectifier_from_settings(p)
    got = port_config.stereo_rectifier_from_settings(p, device="cpu")
    np.testing.assert_allclose(got.map_l.numpy(), np.asarray(want.map_l),
                               atol=1e-4)
    np.testing.assert_allclose(got.map_r.numpy(), np.asarray(want.map_r),
                               atol=1e-4)
    plain = _write(tmp_path, TEXTS["dataset_bf"])
    assert port_config.stereo_rectifier_from_settings(
        plain, device="cpu") is None


@pytest.mark.parametrize("bad", [
    "Camera.fx 517.3\n",                       # no colon
    "  Camera.fx: 1.0\n",                      # indented outside a matrix
    "Camera.fx: 007\n",                        # YAML 1.1 octal
    "Camera.fx: 0x1F\n",                       # hexadecimal
    "Camera.fx: 1:30\n",                       # sexagesimal
    "Camera.fx: .inf\n",
    "Stamp: 2001-12-14\n",                     # a date
    "Camera.D: [1, 2, 3]\n",                   # flow list outside a matrix
    "Camera.fx: !!float 1\n",                  # another tag
    "Name: \"unterminated\n",
    "Camera:\n  fx: 1.0\n",                    # nested mapping
    "- item\n",                                # block list
    "M: !!opencv-matrix\n   rows: 1\n   cols: 2\n   data: [1, 2\n",
    "M: !!opencv-matrix\n   rows: 2\n   cols: 2\n   data: [1, 2, 3]\n",
    "M: !!opencv-matrix\n   rows: 1\n   data: [1]\n",
])
def test_a_line_it_cannot_read_raises(tmp_path, bad):
    p = _write(tmp_path, "%YAML:1.0\nCamera.fy: 2.0\n" + bad)
    with pytest.raises(ValueError, match="settings line"):
        port_config.load_raw(p)


def test_modules_import_no_yaml():
    import subprocess
    import sys
    code = ("import sys; import orb_slam2_e_tpu_torch.examples.rgbd_tum, "
            "orb_slam2_e_tpu_torch.models.viewer, "
            "orb_slam2_e_tpu_torch.utils.config, "
            "orb_slam2_e_tpu_torch.utils.datasets, "
            "orb_slam2_e_tpu_torch.tools.train_vocab, "
            "orb_slam2_e_tpu_torch.tools.profile_step; "
            "bad = {'jax', 'yaml', 'cv2', 'matplotlib'} & set(sys.modules); "
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
