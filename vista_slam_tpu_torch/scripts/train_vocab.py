"""Train a bag-of-words vocabulary from a directory of images (the port of
scripts/train_vocab.py): ORB descriptors from any image corpus, then a
hierarchical k-majority vocabulary (native/bow.py::train_vocabulary), saved
as ``.npz`` or, for a ``.txt`` path, as DBoW3 text. Needs OpenCV.

Usage:
  python -m vista_slam_tpu_torch.scripts.train_vocab --images '/data/frames/*.png' \
      --out pretrains/vocab.npz [--k 10] [--levels 4] [--max-images 500]
"""

from __future__ import annotations

import argparse
import glob

import numpy as np

from ..native.bow import train_vocabulary
from ..utils.optional import require


def main(argv=None):
    cv2 = require("cv2", "OpenCV")

    ap = argparse.ArgumentParser()
    ap.add_argument("--images", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--max-images", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    paths = sorted(glob.glob(args.images))[: args.max_images]
    if not paths:
        raise SystemExit(f"no images matched {args.images}")
    orb = cv2.ORB_create()
    descs, ids = [], []
    for i, p in enumerate(paths):
        img = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
        if img is None:
            continue
        _, d = orb.detectAndCompute(img, None)
        if d is not None:
            descs.append(d)
            ids.append(np.full(len(d), i))
        if (i + 1) % 50 == 0:
            print(f"{i + 1}/{len(paths)} images, {sum(map(len, descs))} descriptors")
    descs = np.concatenate(descs)
    ids = np.concatenate(ids)
    print(f"training k={args.k} L={args.levels} on {len(descs)} descriptors ...")
    vocab = train_vocabulary(descs, k=args.k, levels=args.levels,
                             seed=args.seed, image_ids=ids, n_images=len(paths))
    if args.out.endswith(".txt"):
        vocab.save_dbow_text(args.out)  # DBoW3-compatible text export
    else:
        vocab.save_npz(args.out)
    print(f"saved {vocab.num_words}-word vocabulary to {args.out}")
    return vocab


if __name__ == "__main__":
    main()
