"""The port's pipelined frame loop on a monocular sequence, against the
reference's, on the CPU: tests/test_torch_mono.py's scene and configuration
with `pipeline=True`, each package on its own features and RANSAC draws (a
separate file from tests/test_torch_pipeline.py: the reference compiles a
super-step for each sensor, ~45 s)."""

import numpy as np
import pytest

import test_torch_mono as MONO
from orb_slam2_e_tpu.models.system import (SlamSystem as JSys,
                                           SystemConfig as JCfg,
                                           Sensor as JSensor)
from orb_slam2_e_tpu.ops import camera as jcam
from orb_slam2_e_tpu_torch.models.system import (SlamSystem, SystemConfig,
                                                 Sensor)
from orb_slam2_e_tpu_torch.ops.camera import Camera
from orb_slam2_e_tpu_torch.utils.synthetic import (SyntheticScene,
                                                   orbit_trajectory)
from orb_slam2_e_tpu_torch.utils.trajectory import umeyama_alignment
from test_torch_pipeline import _centre, _run

pytestmark = pytest.mark.e2e


@pytest.fixture(scope="module")
def mono():
    scene = SyntheticScene(**MONO.SCENE)
    poses, centers = orbit_trajectory(n_frames=MONO.N_FRAMES, radius=1.0,
                                      forward=0.04)
    cfg = dict(MONO.CFG, pipeline=True)
    sj = JSys(jcam.Camera.create(**MONO.CAM), JCfg(**cfg), JSensor.MONOCULAR,
              seed=0)
    st = SlamSystem(Camera.create(**MONO.CAM), SystemConfig(**cfg),
                    Sensor.MONOCULAR, device="cpu", seed=0)
    images = [scene.render(R, t) for R, t in poses]

    def feed(s, k):
        return s.track_monocular(images[k], k / 30.0)
    return _run({"jax": sj, "torch": st}, feed, MONO.N_FRAMES), centers


def test_mono_pipelined_matches_reference(mono):
    """Each package on its own features and RANSAC draws: initialization
    within a frame of the reference's, every frame after it tracked, and
    the camera centres held on the frames both tracked, Sim3-aligned, at
    tests/test_torch_mono.py's bounds (ROADMAP Q3 settled #28)."""
    rec, _ = mono
    j, t = rec["jax"], rec["torch"]
    first = [[p is not None for p in r["entries"]].index(True)
             for r in (j, t)]
    assert abs(first[0] - first[1]) <= MONO.INIT_FRAME_SLACK, first
    for r, f in zip((j, t), first):
        assert all(p is not None for p in r["entries"][f:])
        assert r["final"][2] == "OK"
    assert abs(t["final"][1] - j["final"][1]) <= MONO.KF_COUNT_SLACK
    # after initialization the host reads flags every other frame
    assert t["pending"][first[1]] == 0 and max(t["pending"]) == 2
    both = [(a, b) for a, b in zip(j["poses"], t["poses"])
            if a is not None and b is not None]
    a = np.array([_centre(b) for _, b in both])
    b = np.array([_centre(a_) for a_, _ in both])
    s, R, tr = umeyama_alignment(a, b, with_scale=True)
    d = np.linalg.norm((s * (R @ a.T)).T + tr - b, axis=1)
    assert np.median(d) <= MONO.CENTER_MEDIAN_ATOL, d
    assert d.max() <= MONO.CENTER_MAX_ATOL, d
