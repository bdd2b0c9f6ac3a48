"""Keyframe-sharded recognition-database queries over a `torch.distributed`
process group.

Port of `orb_slam2_e_tpu/parallel/dist_db.py`. At map scale the BoW
database is a (K, W) tf-idf matrix with K ~ 10^4 keyframes and W ~ 10^4 to
10^6 words. The keyframe rows are split into one contiguous block per rank;
a query is a per-rank L1 score and top-n over its block, combined with ONE
all-gather of the (n,) candidates of every rank and a global top-n.

The merge is exact: the top-n of a union of per-block top-n is the top-n of
the full score vector (each block surfaces at least its own global
winners). Ties go to the lower slot, as in the single query: blocks are
gathered in rank order and each block's top-n lists equal scores by slot.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import bow
from ..ops.orb import top_k


def pad_rows(vecs, filled, n_dev: int):
    """Pad K to a multiple of n_dev so the row blocks are even."""
    pad = (-vecs.shape[0]) % n_dev
    if pad:
        vecs = torch.cat([vecs, vecs.new_zeros((pad, vecs.shape[1]))])
        filled = torch.cat([filled, filled.new_zeros((pad,))])
    return vecs, filled


def sharded_query(group, vecs, filled, q, n_candidates: int = 5,
                  exclude_mask=None):
    """Top-n keyframe slots by L1 BoW similarity, keyframe-sharded.

    Every rank of `group` (the default group if None) passes the same
    arguments: vecs (K, W) with K % world_size == 0 (`pad_rows`), filled
    (K,) bool, q (W,), exclude_mask optional (K,) bool, True = skip (the
    reference DetectLoopCandidates' covisible exclusion,
    src/KeyFrameDatabase.cc:76-190). Each rank scores only its own block of
    K / world_size rows. Returns (slots (n,), scores (n,)), the same on every
    rank."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    rows = vecs.shape[0] // world
    block = slice(rank * rows, (rank + 1) * rows)
    keep = filled[block]
    if exclude_mask is not None:
        keep = keep & ~exclude_mask[block]
    s = torch.where(keep, bow.l1_score(vecs[block], q),
                    torch.full((rows,), -1.0, dtype=vecs.dtype,
                               device=vecs.device))
    top_s, top_i = top_k(s, min(n_candidates, rows))
    # one collective: every rank sees all blocks' candidates, scores and
    # global slots packed in float64 (exact for both)
    mine = torch.stack([top_s.double(), (top_i + rank * rows).double()])
    gathered = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(gathered, mine, group=group)
    all_s, all_i = torch.cat(gathered, dim=1)
    best_s, pos = top_k(all_s, n_candidates)
    return all_i[pos].long(), best_s.to(vecs.dtype)
