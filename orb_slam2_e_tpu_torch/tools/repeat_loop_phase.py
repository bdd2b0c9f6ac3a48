"""Spread of `chip_smoke.py`'s loop-closing phase over seeds, in one process
on one card.

    python3 -m orb_slam2_e_tpu_torch.tools.repeat_loop_phase 1 2 3

runs `chip_smoke.run_loop(seed)` for every seed given (from the repository
root, where `chip_smoke.py` lies). The scene and the trajectory are the
same each time: what varies is the Sim3 RANSAC draw and the order of the
card's atomic adds. Each run prints the phase's own lines (frame of the
closure, rejections, ATE, stage ms, and a line per Sim3 attempt with its
`compute_sim3` inliers `n_in`, `verify_sim3`'s inliers `n_in2` and
projected matches `n_total` where it got that far, and the landmarks
`search_and_fuse` fused where the loop closed); a run whose gates fail is
reported and the next one still runs. Exits 1 if any failed.
"""

from __future__ import annotations

import sys

import torch


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("repeat_loop_phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    print(chip_smoke.card_line())
    failed = []
    for seed in [int(a) for a in argv] or [0]:
        print(f"--- seed {seed}")
        try:
            chip_smoke.run_loop(seed)
        except AssertionError as e:
            failed.append(seed)
            print(f"seed {seed}: FAILED: {e}")
    print(f"failed seeds: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
