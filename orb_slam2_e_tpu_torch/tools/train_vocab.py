"""Offline ORB vocabulary trainer (twin of tools/train_vocab.py).

Equivalent of the reference's pretrained ORBvoc (reference
include/ORBVocabulary.h:30: k=10, L=6, trained offline from a large image
corpus). The corpus is rendered: many synthetic scenes (varied seeds,
geometry, texture) seen from varied viewpoints, descriptors extracted with
this package's extractor (a vocabulary must match the descriptors it will
quantize). `--images DIR` adds real images to the corpus: every PNG or JPEG
file under DIR, at two scales and two rotations each. (The reference's tool
renders its real-texture frames from the proxy-room generator of
tools/make_proxy_dataset.py, which this package does not have yet; an image
directory takes their place.)

Usage:
    python3 -m orb_slam2_e_tpu_torch.tools.train_vocab --out vocab.npz
        [--k 10] [--L 4] [--scenes 24] [--frames 8] [--images DIR]
        [--device cuda]

Writes the reference's bit-packed npz format (`bow.save_vocabulary` plus the
`meta_*` entries), which `SystemConfig.vocab_path` of either package loads.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import bow
from ..ops.orb import OrbExtractor, resize_bilinear
from ..utils.datasets import read_gray
from ..utils.synthetic import SyntheticScene, orbit_trajectory


def _grab(ext, img, device, descs, docs, doc):
    f = ext(torch.as_tensor(np.asarray(img, np.float32), device=device))
    ok = f.valid.cpu().numpy()
    descs.append(f.desc.cpu().numpy()[ok])
    docs.append(np.full(ok.sum(), doc, np.int32))


def build_corpus(n_scenes: int, n_frames: int, n_features: int, seed0: int,
                 *, device):
    """Render varied synthetic scenes and extract ORB descriptors. Returns
    (descriptors (N, 32) uint8, doc_ids (N,) int32, number of documents):
    one document per rendered frame (for the idf)."""
    ext = OrbExtractor(n_features=n_features, n_levels=8)
    descs, docs = [], []
    doc = 0
    for s in range(n_scenes):
        rng = np.random.RandomState(seed0 + s)
        scene = SyntheticScene(
            n_points=int(rng.uniform(300, 900)), seed=seed0 + s,
            extent=(rng.uniform(3, 8), rng.uniform(2, 6)),
            depth=(rng.uniform(2, 5), rng.uniform(6, 14)),
            width=640, height=480, fx=500, fy=500, cx=320, cy=240)
        poses, _ = orbit_trajectory(
            n_frames=n_frames, radius=rng.uniform(0.5, 2.0),
            forward=rng.uniform(0.0, 0.1), seed=s, jitter=0.02)
        for (R, t) in poses:
            _grab(ext, scene.render(R, t), device, descs, docs, doc)
            doc += 1
        print(f"scene {s + 1}/{n_scenes}: corpus {sum(map(len, descs))}",
              flush=True)
    return np.concatenate(descs), np.concatenate(docs), doc


def build_real_corpus(image_dir, n_features: int, doc0: int, *, device):
    """Real-texture corpus: the image files under `image_dir` at two scales
    and two rotations each, so that the vocabulary sees natural image
    statistics and not only the synthetic square fields. Returns as
    `build_corpus`, documents numbered from `doc0`."""
    ext = OrbExtractor(n_features=n_features, n_levels=8)
    descs, docs = [], []
    doc = doc0
    paths = sorted(p for p in Path(image_dir).rglob("*")
                   if p.suffix.lower() in (".png", ".jpg", ".jpeg"))
    if not paths:
        raise FileNotFoundError(f"no PNG or JPEG file under {image_dir}")
    for p in paths:
        tex = torch.as_tensor(read_gray(p).astype(np.float32))
        for scale in (1.0, 0.6):
            im = tex if scale == 1.0 else resize_bilinear(
                tex, int(round(tex.shape[0] * scale)),
                int(round(tex.shape[1] * scale)))
            if min(im.shape) < 64:
                continue
            for rot in range(2):
                _grab(ext, np.rot90(im.numpy(), rot).copy(), device, descs,
                      docs, doc)
                doc += 1
    print(f"images {len(paths)}: corpus {sum(map(len, descs))}", flush=True)
    return np.concatenate(descs), np.concatenate(docs), doc


def discrimination(voc, desc, docs, cap: int, device):
    """Top-1 against median L1 score between sampled frames: (top-1 mean,
    median mean, margin, frames sampled)."""
    rng = np.random.RandomState(123)
    n_docs = docs.max() + 1
    sample = rng.choice(n_docs, min(200, n_docs), replace=False)
    vecs = []
    for d in sample:
        dd = desc[docs == d][:cap]
        pad = np.zeros((cap, 32), np.uint8)
        pad[:len(dd)] = dd
        mask = torch.arange(cap, device=device) < len(dd)
        words, _ = bow.transform(voc, torch.as_tensor(pad, device=device),
                                 mask)
        vecs.append(bow.bow_vector(voc, words, mask))
    V = torch.stack(vecs)
    # row at a time: the broadcast form is (n, n, W)
    S = torch.stack([bow.l1_score(V, v) for v in V])
    S.fill_diagonal_(-1)
    S = S.cpu().numpy()
    top1 = S.max(1)
    med = np.median(S, axis=1)
    return (float(top1.mean()), float(med.mean()),
            float((top1 - med).mean()), len(sample))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="vocab.npz")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--L", type=int, default=4)
    ap.add_argument("--scenes", type=int, default=24)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--images", default=None,
                    help="directory of real images added to the corpus")
    ap.add_argument("--features", type=int, default=1200)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    t0 = time.time()
    desc, docs, ndoc = build_corpus(args.scenes, args.frames, args.features,
                                    7, device=args.device)
    if args.images:
        desc_r, docs_r, ndoc = build_real_corpus(
            args.images, args.features, ndoc, device=args.device)
        desc = np.concatenate([desc, desc_r])
        docs = np.concatenate([docs, docs_r])
    print(f"corpus: {len(desc)} descriptors from {docs.max() + 1} frames "
          f"({time.time() - t0:.0f}s)")

    t0 = time.time()
    voc = bow.train_vocabulary(desc, k=args.k, L=args.L, iters=args.iters,
                               doc_ids=docs, verbose=True,
                               device=args.device)
    print(f"trained k={args.k} L={args.L} -> {voc.n_words} words "
          f"({time.time() - t0:.0f}s)")

    # discrimination report, stored in the artifact so that tests can check
    # it without rendering a corpus again
    top1, med, margin, n = discrimination(voc, desc, docs, args.features,
                                          args.device)
    print(f"BoW discrimination over {n} frames: top-1 {top1:.3f} vs median "
          f"{med:.3f} (margin {margin:.3f})")

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    arrs = bow.vocabulary_to_arrays(voc)
    arrs.update(meta_margin=np.float32(margin),
                meta_corpus=np.int64(len(desc)),
                meta_docs=np.int64(docs.max() + 1))
    np.savez_compressed(out, **arrs)
    print(f"saved {out} ({out.stat().st_size / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
