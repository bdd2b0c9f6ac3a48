"""Bag-of-binary-words place recognition: vocabulary tree + tf-idf scoring.

Port of `orb_slam2_e_tpu/ops/bow.py` (the reference's DBoW2 roles:
TemplatedVocabulary::transform, BowVector, L1 scoring). The vocabulary is a
flat hierarchical k-medians tree over binary descriptors: node centres
(N, 256) int8 bits and per-word idf weights. `transform` descends all
features level by level at once; a bag-of-words vector is a dense (W,)
tf-idf row, and database scoring is one dense L1 over all keyframes.

The trainer (`train_vocabulary`, numpy) is the reference's fallback when no
vocabulary file exists; the bundled one is read from
`orb_slam2_e_tpu/assets/vocab.npz` by path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import matching


class Vocabulary(NamedTuple):
    """Flat hierarchical vocabulary. Level l (1-based) occupies nodes
    [_level_offset(k, l), _level_offset(k, l + 1)); leaves are level L."""
    node_bits: torch.Tensor  # (N_nodes, 256) int8 centres in {0, 1}
    k: int                   # branching factor
    L: int                   # depth (leaf level)
    idf: torch.Tensor        # (W,) float32 inverse document frequency

    @property
    def n_words(self):
        return self.k ** self.L


def _level_offset(k: int, l: int) -> int:
    """Index of the first node at level l (the root's children are level 1,
    at 0)."""
    return (k ** l - k) // (k - 1) if k > 1 else 0


_POPCNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                        axis=1).sum(1).astype(np.uint8)


def _hamming_packed(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 32) x (M, 32) packed uint8 -> (N, M) int32 Hamming distances
    (XOR + popcount table; the trainer's inner loop)."""
    x = a[:, None, :] ^ b[None, :, :]
    return _POPCNT[x].sum(-1, dtype=np.int32)


def train_vocabulary(descriptors: np.ndarray, k: int = 10, L: int = 4,
                     iters: int = 8, seed: int = 0,
                     doc_ids: np.ndarray = None, verbose: bool = False, *,
                     device) -> Vocabulary:
    """Hierarchical binary k-medians on the host (numpy), the same draw
    and arithmetic as the reference's trainer. descriptors: (N, 32) uint8
    packed. doc_ids: (N,) document (source image) of each descriptor for
    the idf; by default one pseudo-document per 500 descriptors."""
    rng = np.random.RandomState(seed)
    packed = np.ascontiguousarray(descriptors, dtype=np.uint8)
    N = len(packed)

    def majority(data):
        bits = np.unpackbits(data, axis=1, bitorder='little')
        return np.packbits(bits.mean(0) > 0.5, bitorder='little')

    def kmedians(data, k):
        init = data[rng.choice(len(data), min(k, len(data)), replace=False)]
        centers = np.zeros((k, 32), np.uint8)
        centers[:len(init)] = init
        a = None
        for _ in range(iters):
            a_new = _hamming_packed(data, centers).argmin(1)
            if a is not None and (a_new == a).all():
                break
            a = a_new
            for j in range(k):
                sel = data[a == j]
                if len(sel):
                    centers[j] = majority(sel)
        return centers, _hamming_packed(data, centers).argmin(1)

    all_nodes = []
    assign = np.zeros(N, np.int64)       # cluster id at the current level
    for l in range(L):
        n_clusters = k ** l
        next_assign = np.zeros(N, np.int64)
        level_nodes = np.zeros((n_clusters * k, 32), np.uint8)
        order = np.argsort(assign, kind='stable')
        bounds = np.searchsorted(assign[order], np.arange(n_clusters + 1))
        for c in range(n_clusters):
            sel = order[bounds[c]:bounds[c + 1]]
            if len(sel) >= 1:            # an empty cluster stays all-zero
                centers, a = kmedians(packed[sel], k)
                level_nodes[c * k:(c + 1) * k] = centers
                next_assign[sel] = c * k + a
        all_nodes.append(level_nodes)
        assign = next_assign
        if verbose:
            print(f"  vocab level {l + 1}/{L}: "
                  f"{len(np.unique(assign))} live clusters")
    node_bits = np.unpackbits(np.concatenate(all_nodes, axis=0), axis=1,
                              bitorder='little').astype(np.int8)
    W = k ** L
    if doc_ids is None:
        doc_ids = np.arange(N) // 500
    docs, doc_idx = np.unique(doc_ids, return_inverse=True)
    df = np.zeros(W)
    pairs = np.unique(np.stack([doc_idx, assign]), axis=1)
    np.add.at(df, pairs[1], 1.0)
    idf = np.log(max(len(docs), 1) / np.maximum(df, 1.0)) + 1e-3
    return Vocabulary(node_bits=torch.from_numpy(node_bits).to(device),
                      k=k, L=L,
                      idf=torch.from_numpy(idf.astype(np.float32)).to(device))


def transform(voc: Vocabulary, desc_packed: torch.Tensor,
              valid: torch.Tensor):
    """Descend the tree: (F, 32) packed descriptors -> ((F,) word ids,
    valid). At each level the child with the smallest Hamming distance
    wins, the first on ties; the distance is an exact integer count."""
    bits = matching.unpack_desc(desc_packed).to(torch.int8)   # (F, 256)
    F = bits.shape[0]
    ar = torch.arange(voc.k, device=bits.device)
    node = torch.zeros((F,), dtype=torch.int64, device=bits.device)
    for l in range(voc.L):
        child_ids = (_level_offset(voc.k, l + 1) + node[:, None] * voc.k
                     + ar[None, :])
        d = (voc.node_bits[child_ids] != bits[:, None, :]).sum(-1)  # (F, k)
        node = node * voc.k + torch.argmin(d, dim=-1)
    return torch.where(valid, node, 0).to(torch.int32), valid


def bow_vector(voc: Vocabulary, words: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """(F,) word ids -> L1-normalised tf-idf vector (W,) (reference
    BowVector::addWeight + normalize(L1)). The tf counts add 1.0 per word
    with `index_add_`: sums of integers below 2^24 are exact in float32 in
    any order, so the card's atomics need no fixed order
    (`scatter.segment_sum`), and the counts, and the vector, equal the
    reference's."""
    idx = torch.where(valid, words, 0).long()
    tf = torch.zeros((voc.n_words,), dtype=torch.float32,
                     device=words.device).index_add_(
        0, idx, valid.to(torch.float32))
    v = tf * voc.idf
    return v / torch.clamp(torch.abs(v).sum(), min=1e-9)


def l1_score(db: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity of L1-normalised vectors,
    s = 1 - 0.5 * |v1 - v2|_1, over database rows (K, W) x (W,)."""
    return 1.0 - 0.5 * torch.abs(db - q[None, :]).sum(-1)


def vocabulary_to_arrays(voc: Vocabulary) -> dict:
    """Flatten for npz storage; node centres bit-packed (32 B per node)."""
    packed = np.packbits(voc.node_bits.cpu().numpy().astype(np.uint8),
                         axis=1, bitorder='little')
    return {"voc_nodes_packed": packed, "voc_k": np.asarray(voc.k),
            "voc_L": np.asarray(voc.L), "voc_idf": voc.idf.cpu().numpy()}


def vocabulary_from_arrays(d: dict, *, device) -> "Vocabulary | None":
    """The npz arrays -> a Vocabulary on `device` (None without nodes)."""
    if "voc_nodes_packed" not in d:
        return None
    bits = np.unpackbits(np.asarray(d["voc_nodes_packed"]), axis=1,
                         bitorder='little').astype(np.int8)
    return Vocabulary(
        node_bits=torch.from_numpy(bits).to(device), k=int(d["voc_k"]),
        L=int(d["voc_L"]),
        idf=torch.from_numpy(np.asarray(d["voc_idf"], np.float32)).to(device))


def save_vocabulary(path, voc: Vocabulary):
    """One compressed npz, the reference's format: either package loads
    the other's file."""
    np.savez_compressed(path, **vocabulary_to_arrays(voc))


def load_vocabulary(path, *, device) -> "Vocabulary | None":
    with np.load(path) as d:
        return vocabulary_from_arrays(dict(d), device=device)
