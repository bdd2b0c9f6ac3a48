"""Spread of `chip_smoke.py`'s loop-closing phase over seeds, in one process
on one card, with every closure's fusion run again on the CPU.

    python3 -m orb_slam2_e_tpu_torch.tools.repeat_loop_phase 1 2 3
        [--save-dir DIR]

runs `chip_smoke.run_loop(seed)` for every seed given (from the repository
root, where `chip_smoke.py` lies). The scene and the trajectory are the
same each time: what varies is the Sim3 RANSAC draw (the float sums add in
one fixed order, so a seed given twice repeats its run). Each run prints the phase's own lines (frame of the
closure, rejections, ATE, stage ms, and a line per Sim3 attempt with its
`compute_sim3` inliers `n_in`, `verify_sim3`'s inliers `n_in2` and
projected matches `n_total` where it got that far, and the landmarks
`search_and_fuse` fused where the loop closed); a run whose gates fail is
reported and the next one still runs. Exits 1 if any failed.

Every `search_and_fuse` of a closure is also run on copies of its inputs
on the CPU (the map, the corrected poses, the two keyframes), and both
runs print how many loop landmarks each test of the projection keeps in
each keyframe of the corrected neighborhood, the landmarks fused, and the
fields of the fused maps that differ. The inputs of the first closure that
fuses fewer than `POOR_FUSION` landmarks are saved to
`<save-dir>/fuse_case_seed<seed>.npz` (default: the working directory).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

POOR_FUSION = 200
STAGES = ("live", "in_front", "in_image", "scale_window", "candidate",
          "desc_dist", "one_per_feature", "bound", "replaced")


def _cpu(x):
    return x.cpu() if isinstance(x, torch.Tensor) else x


def _table(trace) -> list:
    """The trace's rows as lists of ints (one host read)."""
    if not trace:
        return []
    flat = torch.stack([torch.stack([r["kf"].long()] + [r[k].long()
                                                        for k in STAGES])
                        for r in trace]).cpu().tolist()
    return [row for row in flat if row[1] > 0]


def fuse_on_both(saved, seed, log: list, save_dir: str = "."):
    """A `search_and_fuse` that runs the card's call, then the same call on
    CPU copies of its inputs, and prints both."""
    from orb_slam2_e_tpu_torch.utils import convert

    def fuse(cam, state, kf_cur, kf_loop, *rest, **kw):
        cpu_args = (cam.to("cpu"), type(state)(*(v.cpu() for v in state)),
                    _cpu(kf_cur), _cpu(kf_loop))
        tr_card, tr_cpu = [], []
        out = saved(cam, state, kf_cur, kf_loop, *rest, trace=tr_card, **kw)
        out_cpu = saved(*cpu_args, *rest, trace=tr_cpu, **kw)
        n_card, n_cpu = int(out[1]), int(out_cpu[1])
        diff = {k: int((a.cpu() != b).sum())
                for (k, a), b in zip(out[0]._asdict().items(), out_cpu[0])
                if not torch.equal(a.cpu(), b)}
        print(f"[fuse] seed {seed}: keyframe {int(kf_cur)} -> "
              f"{int(kf_loop)}: fused {n_card} on the card, {n_cpu} on the "
              f"CPU; fields of the fused maps that differ: {diff or 'none'}")
        print("[fuse] per keyframe of the neighborhood (card | CPU): kf, "
              + ", ".join(STAGES))
        for a, b in zip(_table(tr_card), _table(tr_cpu)):
            print(f"[fuse]   {a} | {b}")
        log.append({"seed": seed, "card": n_card, "cpu": n_cpu,
                    "differ": diff})
        if n_card < POOR_FUSION and not any(
                e["card"] < POOR_FUSION for e in log[:-1]):
            os.makedirs(save_dir, exist_ok=True)
            path = os.path.join(save_dir, f"fuse_case_seed{seed}.npz")
            arrays = {f"map_{k}": v for k, v in
                      convert.to_numpy(cpu_args[1]).items()}
            arrays.update({f"cam_{k}": v for k, v in
                           convert.to_numpy(cpu_args[0]).items()})
            np.savez_compressed(path, kf_cur=int(kf_cur),
                                kf_loop=int(kf_loop), **arrays)
            print(f"[fuse] inputs saved to {path}")
        return out
    return fuse


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("repeat_loop_phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from orb_slam2_e_tpu_torch.models import loop_closing
    print(chip_smoke.card_line())
    save_dir = "."
    if "--save-dir" in argv:
        i = argv.index("--save-dir")
        save_dir, argv = argv[i + 1], argv[:i] + argv[i + 2:]
    failed, log = [], []
    saved = loop_closing.search_and_fuse
    try:
        for seed in [int(a) for a in argv] or [0]:
            print(f"--- seed {seed}")
            loop_closing.search_and_fuse = fuse_on_both(saved, seed, log,
                                                        save_dir)
            try:
                chip_smoke.run_loop(seed)
            except AssertionError as e:
                failed.append(seed)
                print(f"seed {seed}: FAILED: {e}")
    finally:
        loop_closing.search_and_fuse = saved
    print(f"fusions (card, CPU): "
          f"{[(e['seed'], e['card'], e['cpu']) for e in log]}")
    print(f"failed seeds: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
