"""Keyframe recognition database: per-keyframe BoW vectors, dense scoring.

Port of `orb_slam2_e_tpu/models/kf_database.py` (reference
KeyFrameDatabase: add, erase, DetectRelocalizationCandidates,
DetectLoopCandidates). The inverted file is a dense (K, W) tf-idf matrix,
and a query is one L1 over every keyframe.
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


def detect_loop_candidates_full(db: BowDatabase, q: torch.Tensor, state, kf,
                                n_candidates: int = 5):
    """Loop-candidate query for keyframe `kf` (the reference DetectLoop
    preamble, LoopClosing.cc:103-150): covisible keyframes are excluded, the
    lowest score among the strongly covisible ones (>= 15 shared points) is
    the minimum score, and the best `n_candidates` are ranked, the lower
    slot first on ties (with few eligible keyframes several scores are -1
    and tie). Nothing is read by the host.

    Returns (slots (n,), scores (n,), groups (n, K) bool): each candidate's
    covisibility group (itself and its covisible keyframes) for the
    host-side consistency check."""
    covis = state.covisibility_row(kf)
    scores = query_scores(db, q)
    covis_mask = (covis >= 15) & state.kf_valid
    inf = torch.full_like(scores, float("inf"))
    min_score = torch.min(torch.where(covis_mask, scores, inf))
    min_score = torch.where(torch.isfinite(min_score),
                            torch.clamp(min_score, min=0.01),
                            torch.full_like(min_score, 0.05))
    exclude = (covis > 0) | ~state.kf_valid
    exclude[kf] = True
    minus1 = torch.full_like(scores, -1.0)
    s = torch.where(exclude, minus1, scores)
    s = torch.where(s >= min_score, s, minus1)
    top_s, top_i = top_k(s, n_candidates)
    grp = torch.stack([state.covisibility_row(top_i[c]) > 0
                       for c in range(n_candidates)])
    grp[torch.arange(n_candidates, device=grp.device), top_i] = True
    return top_i, top_s, grp
