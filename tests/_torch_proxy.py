"""Shared by the proxy-tool tests: the reference's generators loaded from
tools/ by path (they are scripts, not a package, and import JAX, OpenCV and
matplotlib), and the tolerances the port's twins are held to."""

import importlib.util
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")

# The twin's render against the reference's on the same planes and poses:
# every frame measured (3 poses each of xyz and desk, one KITTI, one
# distorted EuRoC, one endoscopy frame at amplitude 0.12, at 160x120 /
# 160x64 / 512x384 / 120x90) came out equal, grey levels and depth bit for
# bit: the bilinear sampling reproduces OpenCV's three fused
# multiply-adds, each a float64 a * b + c rounded once to float32.
RENDER_MAX = 0
RENDER_SHARE = 0.0
DEPTH_ATOL = 0.0
# A generator's own frames, where its pose is 1 float32 ulp apart from the
# reference's (below): over the frames of 0..57 (every third) of xyz, desk
# and KITTI whose rotation differs, at most 1 grey level on at most 2.5e-4
# of the pixels (xyz frame 21), depth 1 float32 ulp apart (2.4e-7
# relative), so a 16-bit depth count at most 1 apart.
POSE_RENDER_MAX = 1
POSE_RENDER_SHARE = 2.5e-4
POSE_DEPTH_COUNTS = 1

# Ground truth: the reference forms each rotation with lie.so3_exp in
# float32 under XLA, whose cos rounds apart from torch's on ~9% of these
# angles (70 of the 800 rotations of the two 400-frame trajectories differ
# by 1 float32 ulp). Printed to 7 decimals, 1 of the first 20 xyz lines and
# none of the desk and KITTI lines differ, by one unit in the last digit.
GT_LAST_DIGIT = 1e-7 + 1e-12
GT_LINES_APART = 1          # of the first 20 of a trajectory


def load_original(name: str):
    """tools/<name>.py as a module (its own sys.path edits included)."""
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    spec = importlib.util.spec_from_file_location(
        "ref_" + name, os.path.join(TOOLS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gt_apart(lines_a, lines_b):
    """(lines that differ, largest difference of a number) of two lists of
    TUM ground-truth lines."""
    n, worst = 0, 0.0
    for a, b in zip(lines_a, lines_b, strict=True):
        if a != b:
            n += 1
            worst = max(worst, max(abs(float(u) - float(v)) for u, v in
                                   zip(a.split(), b.split(), strict=True)))
    return n, worst
