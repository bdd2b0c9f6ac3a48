"""Keyframe recognition database: per-keyframe BoW vectors, dense scoring.

Port of the relocalization part of `orb_slam2_e_tpu/models/kf_database.py`
(reference KeyFrameDatabase: add, erase, DetectRelocalizationCandidates).
The inverted file is a dense (K, W) tf-idf matrix, and a query is one L1
over every keyframe. Loop-candidate detection waits for loop closing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import bow
from ..ops.orb import top_k


class BowDatabase(NamedTuple):
    vecs: torch.Tensor     # (K, W) L1-normalised tf-idf rows
    filled: torch.Tensor   # (K,) bool

    @staticmethod
    def create(max_keyframes: int, n_words: int, *,
               device) -> "BowDatabase":
        return BowDatabase(
            vecs=torch.zeros((max_keyframes, n_words), device=device),
            filled=torch.zeros((max_keyframes,), dtype=torch.bool,
                               device=device))

    def _put(self, slot, vec, filled: bool) -> "BowDatabase":
        # in place: the system holds the one database, and a copy of the
        # (K, W) matrix per keyframe would cost more than the row
        self.vecs[slot] = vec
        self.filled[slot] = filled
        return self

    def add(self, slot, vec) -> "BowDatabase":
        """Reference KeyFrameDatabase::add."""
        return self._put(slot, vec, True)

    def erase(self, slot) -> "BowDatabase":
        """Reference KeyFrameDatabase::erase."""
        return self._put(slot, 0.0, False)


def query_scores(db: BowDatabase, q: torch.Tensor) -> torch.Tensor:
    """(K,) L1 similarity of q against every stored keyframe, -1 where the
    slot is empty."""
    return torch.where(db.filled, bow.l1_score(db.vecs, q),
                       torch.full_like(db.vecs[:, 0], -1.0))


def detect_relocalization_candidates(db: BowDatabase, q: torch.Tensor,
                                     n_candidates: int = 5):
    """Reference KeyFrameDatabase::DetectRelocalizationCandidates: no
    exclusion, ranked by score, the lower slot first on ties (as
    `jax.lax.top_k`). Returns (slots (n,), scores (n,))."""
    top_s, top_i = top_k(query_scores(db, q), n_candidates)
    return top_i, top_s
