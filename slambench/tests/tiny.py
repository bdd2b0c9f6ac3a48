"""Tiny CPU versions of the benchmark's cells for the tests: the same
files, cut to half-size images, few features and levels and small
capacities, so that a whole run takes seconds on the CPU."""

from __future__ import annotations

import copy

import numpy as np

from slambench import harness

SHRINK = 2


def shrink_config(config: dict) -> dict:
    c = copy.deepcopy(config)
    s = c["settings"]
    f = 1.0 / SHRINK
    for k in ("Camera.fx", "Camera.fy", "Camera.cx", "Camera.cy",
              "Camera.bf"):
        s[k] *= f
    for k in ("Camera.width", "Camera.height", "LEFT.width", "LEFT.height",
              "RIGHT.width", "RIGHT.height"):
        if k in s:
            s[k] = int(s[k] // SHRINK)
    for side in ("LEFT", "RIGHT"):
        if f"{side}.K" in s:
            K = np.asarray(s[f"{side}.K"], np.float64).reshape(3, 3)
            K[:2] *= f
            s[f"{side}.K"] = K.ravel().tolist()
            P = np.asarray(s[f"{side}.P"], np.float64).reshape(3, 4)
            P[:2] *= f
            s[f"{side}.P"] = P.ravel().tolist()
    s["ORBextractor.nFeatures"] = 500
    s["ORBextractor.nLevels"] = 4
    c["system"] = dict(c["system"], max_keyframes=12, max_points=2048)
    return c


# cells whose files are kept for a later benchmark, though BENCHMARK.json
# leaves them out
KEPT = {"tum1_rgbd.lanes8": {"name": "tum1_rgbd.lanes8", "config": "tum1_rgbd",
                             "traffic": "lanes8", "chips": 1}}


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.Cell(name, entry=KEPT.get(name))
    cell.config = shrink_config(cell.config)
    mix = copy.deepcopy(cell.mix)
    mix["motion"]["period_frames"] = 24
    for t in mix["motion"]["terms"]:
        t["amp"] *= 0.3
    if "setup_frames" in mix:
        mix["setup_frames"] = 3
    if "map_frames" in mix:
        mix["map_frames"] = 6
        mix["lanes"] = 2
        mix["lane_starts"] = [4, 5]
    mix["profile_frames"] = [1, 2]
    cell.mix = mix
    cell.file = dict(cell.file, sample=2)
    if "ate_frames" in cell.file:
        cell.file["ate_frames"] = 6
    return cell
