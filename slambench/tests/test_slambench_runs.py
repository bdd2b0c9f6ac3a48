"""Whole runs of each traffic kind at a tiny size on the CPU: the last line
has exactly the contract's keys, a run without a card refuses, the control
(the reference in bfloat16 in the program's place) and each fault a cell
can have, planted in the timed path, come out as not correct."""

import json

import pytest
import torch

from slambench import run
from slambench.readings import readings
from slambench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 5
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
CELLS = ["tum1_rgbd.desk_xyz", "euroc_stereo.mh_sweep", "tum1_rgbd.lanes8"]


def tiny_line(name, trace=False, cell=None):
    cell = cell or tiny_cell(name)
    return run.run_cell(cell, SEED, 1.0, trace, "cpu", 0.0)[1]


@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_prints_the_contract_keys(name):
    line = json.loads(json.dumps(tiny_line(name)))
    assert set(line) == KEYS
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    assert line["metrics"] == {}          # no device metric from the CPU
    assert set(line["checks"]) == set(tiny_cell(name).file["limits"])


def test_traced_tiny_run():
    line = tiny_line("tum1_rgbd.desk_xyz", trace=True)
    assert set(line) == KEYS and line["correct"] is True


def test_no_card_refuses(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "tum1_rgbd.desk_xyz", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "no result" in out.err


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    (rec,) = readings(tiny_cell(name), [SEED + 1], 1.0, "cpu")
    assert rec["program_correct"] is True, rec["program"]
    assert rec["control_correct"] is False, rec["control"]


def _unchanged(track):
    """The tracking step returns its input state and the last frame."""
    def step(cam, cfg, state, frame, last_frame, *rest):
        _, _, vel, flags = track(cam, cfg, state, frame, last_frame, *rest)
        return state, last_frame, vel, flags
    return step


def _altered(track):
    """The tracking step's pose moved by 1 cm where it is produced."""
    def step(*args):
        state, frame, vel, flags = track(*args)
        shift = torch.zeros_like(frame.pose7)
        shift[..., 4] = 0.01
        return state, frame._replace(pose7=frame.pose7 + shift), vel, flags
    return step


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _altered])
def test_fault_in_the_timed_path_is_not_correct(monkeypatch, name, fault):
    from orb_slam2_e_tpu_torch.models import tracking
    monkeypatch.setattr(tracking, "track_frame_fused",
                        fault(tracking.track_frame_fused))
    line = tiny_line(name)
    assert line["correct"] is False, line["checks"]


def _ba_unchanged(monkeypatch):
    """The local BA's solve returns the landmarks and poses it was given."""
    from orb_slam2_e_tpu_torch.ops import ba
    solve = ba.ba_solve

    def unchanged(cam, prob, *args, **kwargs):
        res = solve(cam, prob, *args, **kwargs)
        return res._replace(cam_pose7=prob.cam_pose7, points=prob.points)
    monkeypatch.setattr(ba, "ba_solve", unchanged)


def _mapping_unchanged(monkeypatch):
    """The mapping pass returns the map it was given."""
    from orb_slam2_e_tpu_torch.models import local_mapping
    mapping = local_mapping.mapping_pass_dyn

    def unchanged(cam, cfg, state, kf, *args):
        _, counts = mapping(cam, cfg, state, kf, *args)
        return state, counts
    monkeypatch.setattr(local_mapping, "mapping_pass_dyn", unchanged)


@pytest.mark.parametrize("name", CELLS[:2])
@pytest.mark.parametrize("fault", [_ba_unchanged, _mapping_unchanged])
def test_map_left_unchanged_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    line = tiny_line(name)
    assert line["correct"] is False, line["checks"]
    assert not line["checks"]["ba_shortfall"]["value"] or (
        line["checks"]["ba_shortfall"]["value"] > 0.5)


def test_half_the_lanes_left_out_is_not_correct(monkeypatch):
    from orb_slam2_e_tpu_torch.parallel.batched import BatchedTracker
    step = BatchedTracker.step

    def half(self, images, ref_kfs):
        before = self.last_frames
        ok, n_in = step(self, images, ref_kfs)
        keep = self.B // 2
        self.last_frames = type(before)(*(
            torch.cat([new[:keep], old[keep:]])
            for new, old in zip(self.last_frames, before)))
        return ok, n_in

    monkeypatch.setattr(BatchedTracker, "step", half)
    cell = tiny_cell("tum1_rgbd.lanes8")
    cell.file = dict(cell.file, sample=64)
    line = tiny_line("tum1_rgbd.lanes8", cell=cell)
    assert line["correct"] is False, line["checks"]
