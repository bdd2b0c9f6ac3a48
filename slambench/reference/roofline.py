"""The card's peaks and the least time the two CUDA kernels of the program
could take for the work their inputs need.

Copied from the program's chip check (`chip_smoke.py`: `bound_ms`,
`segment_bound_ms`) with the early-reject count taken by this package's
own plain copy (`orb.may_score`), so that the yardstick never moves with
the program.

Peaks, NVIDIA's data sheet for the H100 SXM at its 700 W limit:
3.35e12 B/s of HBM3; 67e12 float32 operations per second outside the tensor
cores, which counts a fused multiply-add as two, so a stream of single
operations peaks at half of it.
"""

from __future__ import annotations

import torch

from . import orb

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12 / 2

# fast_nms_blur: each pixel read once (float32) and written twice (score
# and blur). Operations per pixel, none of them a fused multiply-add: on
# every pixel the 4 compass differences, 15 min/max and 1 compare of the
# exact early reject, and the 26 of the blur; where the reject passes, the
# other 12 ring differences, 128 of the window trees, 30 of the arc
# reductions and 7 to combine and threshold; where the score is not 0, the
# 16 of the 3x3 non-max suppression.
BYTES_PER_PIXEL = 12
OPS_EVERY_PIXEL = 4 + 15 + 1 + 26
OPS_WHERE_SCORE_POSSIBLE = 12 + 128 + 30 + 7
OPS_WHERE_SCORE_NOT_0 = 16


def fast_nms_blur_counts(levels, th_high: float, th_low: float) -> dict:
    """Pixels, pixels the early reject passes and pixels with a non-zero
    suppressed score, over the float32 level images of one launch."""
    n_px = sum(int(img.numel()) for img in levels)
    th = min(th_high, th_low)
    possible = sum(int(orb.may_score(img.float(), th).sum())
                   for img in levels)
    not0 = sum(int((orb.nms3x3(orb.fast_score_map(img.float(), th_high,
                                                  th_low)) != 0).sum())
               for img in levels)
    return {"pixels": n_px, "score_possible": possible, "score_not_0": not0}


def fast_nms_blur_bound_s(counts: dict) -> float:
    """The least seconds of one launch over those levels: the larger of the
    bytes at the HBM peak and the operations at the float32 peak."""
    ops = (counts["pixels"] * OPS_EVERY_PIXEL
           + counts["score_possible"] * OPS_WHERE_SCORE_POSSIBLE
           + counts["score_not_0"] * OPS_WHERE_SCORE_NOT_0)
    return max(counts["pixels"] * BYTES_PER_PIXEL / PEAK_BYTES_PER_S,
               ops / PEAK_F32_OPS_PER_S)


def segment_sum_bound_s(n: int, cols: int, live: int) -> float:
    """The least seconds of one segment sum of `live` rows of `cols` float32
    columns into `n` segments: the live rows' values and their int64
    permutation entries read once, the n + 1 int64 offsets read once, the
    (n, cols) output written once; one float add per live value."""
    moved = live * cols * 4 + live * 8 + (n + 1) * 8 + n * cols * 4
    return max(moved / PEAK_BYTES_PER_S, live * cols / PEAK_F32_OPS_PER_S)


def live_rows(idx: torch.Tensor, n: int) -> int:
    """Rows of a segment sum's index that land in a segment (idx < n)."""
    return int((idx.reshape(-1) < n).sum())
