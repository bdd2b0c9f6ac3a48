"""On the card only (`cuda` marker; the fixture decides, never the import):
a tiny traced run of each traffic kind reads every per-layer metric its
cell lists from a real device trace, and no kernel's roofline share
passes 100%."""

import pytest
import torch

from slambench import run
from slambench.tests.tiny import tiny_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the trace's device events")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tum1_rgbd.desk_xyz",
                                  "euroc_stereo.mh_sweep",
                                  "tum1_rgbd.lanes8"])
def test_traced_run_on_the_card(card, name):
    cell = tiny_cell(name)
    cell.mix = dict(cell.mix, profile_frames=[2, 6])
    _, line = run.run_cell(cell, 2 ** 31 + 9, 3.0, True, card, 0.0)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    wanted = {m["name"] for m in cell.per_layer}
    assert wanted - set(line["metrics"]) <= {"loop_ms_per_kf"}
    for key, m in line["metrics"].items():
        if key.endswith("_roofline"):
            assert 0 < m["value"] <= 100, (key, m)
    assert line["breakdown"]["device_ops"]
