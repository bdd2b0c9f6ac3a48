"""Binary descriptor matching as dense masked matrix ops.

Port of `orb_slam2_e_tpu/ops/matching.py`: a Hamming distance matrix, a
candidate mask, a best/second-best reduction with the ratio test, and the
rotation-consistency histogram.

The Hamming matrix is |a| + |b| - 2 a.b over unpacked {0, 1} bits, with the
a.b term as one float32 matmul: every partial sum is an integer below 2^24,
so the result is exact. Ties keep the reference's order everywhere (lower
index first), through stable sorts.
"""

from __future__ import annotations

import numpy as np
import torch

TH_HIGH = 95
TH_LOW = 45
TH_RELOC = 60          # full-map relocalization search
HISTO_LENGTH = 30
INVALID = -1
BIG = 10 ** 6


def unpack_desc(packed: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 -> (N, 256) float32 in {0, 1} (bit i of byte j -> col
    8j+i). The reference keeps int8; float32 feeds the exact f32 matmul."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1).to(torch.float32)


def hamming_matrix(bits_a: torch.Tensor, bits_b: torch.Tensor):
    """(Na, 256) x (Nb, 256) {0,1} -> (Na, Nb) int32 Hamming distances."""
    dot = bits_a @ bits_b.T
    na = bits_a.sum(1)
    nb = bits_b.sum(1)
    return (na[:, None] + nb[None, :] - 2.0 * dot).to(torch.int32)


def hamming_pairs(bits_a: torch.Tensor, bits_b: torch.Tensor):
    """Row-wise Hamming distance of aligned pairs: (N, 256) x2 -> (N,)."""
    return torch.abs(bits_a.to(torch.int32)
                     - bits_b.to(torch.int32)).sum(-1).to(torch.int32)


def mutual_filter(best_ab: torch.Tensor, best_ba: torch.Tensor):
    """Cross-check: keep a->b only if b->a maps back. (Na,), (Nb,) ->
    (Na,) bool."""
    nb = best_ba.shape[0]
    ok = (best_ab >= 0) & (best_ab < nb)
    back = torch.where(ok, best_ba[torch.clamp(best_ab, 0, nb - 1).long()],
                       -2)
    return ok & (back == torch.arange(best_ab.shape[0],
                                      device=best_ab.device))


def masked_best2(dist: torch.Tensor, mask: torch.Tensor):
    """Per-row best and second-best over masked columns.

    Returns (best_idx (Na,), best_d (Na,), second_d (Na,)); best_d == BIG
    where no candidate. Equal distances: lowest column first, as
    `jax.lax.top_k(-d, 2)`."""
    d = torch.where(mask, dist, torch.full_like(dist, BIG))
    best = torch.argmin(d, dim=1)                  # first minimum
    best_d = torch.gather(d, 1, best[:, None])
    rest = d.scatter(1, best[:, None], torch.iinfo(torch.int32).max)
    return best, best_d[:, 0], torch.amin(rest, dim=1)


def _py_mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """Float modulo with the divisor's sign, computed as jnp.remainder does
    (exact fmod, then one correcting add)."""
    m = torch.tensor(m, dtype=x.dtype, device=x.device)
    r = torch.fmod(x, m)
    return torch.where((r != 0) & (r < 0), r + m, r)


def rotation_consistency_mask(angle_a: torch.Tensor, angle_b: torch.Tensor,
                              pair_valid: torch.Tensor,
                              min_pairs: int = 8) -> torch.Tensor:
    """Keep only matches whose angle difference falls in the 3 most popular
    of 30 bins (reference ORBmatcher::ComputeThreeMaxima); pass-through
    with fewer than `min_pairs` valid pairs."""
    diff = _py_mod(angle_a - angle_b, 2 * np.pi)      # [0, 2pi)
    bin_f = diff * (HISTO_LENGTH / (2 * np.pi))
    bins = torch.clamp(bin_f.to(torch.int32), 0, HISTO_LENGTH - 1).long()
    hist = torch.zeros((HISTO_LENGTH,), dtype=torch.int32,
                       device=angle_a.device)
    hist = hist.scatter_add(0, bins, pair_valid.to(torch.int32))
    counts, top_bins = torch.sort(hist, descending=True, stable=True)
    top3_counts, top3_bins = counts[:3], top_bins[:3]
    floor = torch.clamp((0.1 * top3_counts[0].to(torch.float32)).to(
        torch.int32), min=1)
    keep_bin = top3_counts >= floor
    allowed = torch.zeros((HISTO_LENGTH,), dtype=torch.bool,
                          device=angle_a.device).scatter(0, top3_bins,
                                                         keep_bin)
    enough = pair_valid.sum() >= min_pairs
    return pair_valid & (allowed[bins] | ~enough)


def window_mask(uv_query: torch.Tensor, uv_train: torch.Tensor,
                radius) -> torch.Tensor:
    """(Na, 2), (Nb, 2) -> (Na, Nb): train kp within radius of the query
    (scalar or per-query radius)."""
    r = torch.as_tensor(radius, device=uv_query.device)
    if r.dim() == 1:
        r = r[:, None]
    du = torch.abs(uv_query[:, None, 0] - uv_train[None, :, 0])
    dv = torch.abs(uv_query[:, None, 1] - uv_train[None, :, 1])
    return (du <= r) & (dv <= r)


def octave_range_mask(pred_octave: torch.Tensor, kp_octave: torch.Tensor,
                      lo_off: int = -1, hi_off: int = 1) -> torch.Tensor:
    """(Na,), (Nb,) -> (Na, Nb): kp octave within [pred+lo, pred+hi]."""
    lo = pred_octave[:, None] + lo_off
    hi = pred_octave[:, None] + hi_off
    return (kp_octave[None, :] >= lo) & (kp_octave[None, :] <= hi)


def search_windowed(bits_a, bits_b, uv_a, uv_b, valid_a, valid_b,
                    radius, max_dist: int = TH_LOW, ratio: float = 0.9,
                    angles=None):
    """Windowed search a -> b (reference ORBmatcher::SearchForInitialization:
    window, ratio test, rotation check). Returns (match_idx (Na,) int32 or
    -1, dist (Na,) int32, BIG where unmatched)."""
    dist = hamming_matrix(bits_a, bits_b)
    mask = window_mask(uv_a, uv_b, radius)
    mask &= valid_a[:, None] & valid_b[None, :]
    best_idx, d1, d2 = masked_best2(dist, mask)
    ok = (d1 <= max_dist) & (d1.to(torch.float32)
                             < ratio * d2.to(torch.float32))
    if angles is not None:
        ang_a, ang_b = angles
        ok = rotation_consistency_mask(
            ang_a, ang_b[torch.clamp(best_idx, 0, bits_b.shape[0] - 1)], ok)
    return (torch.where(ok, best_idx, INVALID).to(torch.int32),
            torch.where(ok, d1, BIG))


def resolve_duplicates(match_idx: torch.Tensor, dist: torch.Tensor,
                       n_train: int) -> torch.Tensor:
    """Enforce injectivity: of several queries matching one train index,
    keep the smallest distance, ties to the lowest query index."""
    dev = match_idx.device
    n_q = match_idx.shape[0]
    safe = torch.clamp(match_idx, 0, n_train - 1).long()
    valid = match_idx >= 0
    dist = dist.to(torch.int32)
    big = torch.full((n_train,), BIG, dtype=torch.int32, device=dev)
    best_per_train = big.scatter_reduce(
        0, safe, torch.where(valid, dist, torch.full_like(dist, BIG)),
        reduce="amin", include_self=True)
    keep = valid & (dist <= best_per_train[safe])
    qidx = torch.arange(n_q, dtype=torch.int64, device=dev)
    first_q = torch.full((n_train,), n_q, dtype=torch.int64,
                         device=dev).scatter_reduce(
        0, safe, torch.where(keep, qidx, torch.full_like(qidx, n_q)),
        reduce="amin", include_self=True)
    keep &= first_q[safe] == qidx
    return torch.where(keep, match_idx,
                       torch.full_like(match_idx, INVALID))
