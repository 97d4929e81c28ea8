"""Extract qualitative figures from saved SLAM results: RGB keyframes,
colorized depth and confidence maps (the port of scripts/extract_images.py).
Reads the directory that ``OnlineSLAM.save_data_all`` writes. Needs OpenCV
(the PNG writer) and matplotlib (the colour map).

Usage:
  python -m vista_slam_tpu_torch.scripts.extract_images --result-dir output/test --views 0 10 20
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils.optional import require


def colorize(x, mask=None, cmap="turbo"):
    matplotlib = require("matplotlib", "matplotlib")
    v = x.astype(np.float64)
    if mask is None:
        mask = np.isfinite(v) & (v > 0)
    lo, hi = (np.percentile(v[mask], [2, 98]) if mask.any() else (0, 1))
    norm = np.clip((v - lo) / max(hi - lo, 1e-8), 0, 1)
    rgba = matplotlib.colormaps[cmap](norm)
    out = (rgba[..., :3] * 255).astype(np.uint8)
    out[~mask] = 0
    return out


def main(argv=None):
    cv2 = require("cv2", "OpenCV")

    ap = argparse.ArgumentParser()
    ap.add_argument("--result-dir", required=True)
    ap.add_argument("--views", type=int, nargs="*", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    rd = args.result_dir
    images = np.load(os.path.join(rd, "images.npy"))
    depths = np.load(os.path.join(rd, "depths.npy"))
    scales = np.load(os.path.join(rd, "scales.npy"))
    with np.load(os.path.join(rd, "confs.npz")) as z:
        confs, thres = z["confs"], float(z["thres"])

    out_dir = args.out or os.path.join(rd, "figures")
    os.makedirs(out_dir, exist_ok=True)
    views = args.views if args.views is not None else \
        list(range(0, len(images), max(len(images) // 8, 1)))
    for v in views:
        rgb = (images[v] * 255).astype(np.uint8)
        depth = depths[v] * scales[v]
        mask = confs[v] > thres
        cv2.imwrite(os.path.join(out_dir, f"view{v:04d}_rgb.png"),
                    cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        cv2.imwrite(os.path.join(out_dir, f"view{v:04d}_depth.png"),
                    cv2.cvtColor(colorize(depth, mask), cv2.COLOR_RGB2BGR))
        cv2.imwrite(os.path.join(out_dir, f"view{v:04d}_conf.png"),
                    cv2.cvtColor(colorize(confs[v], np.ones_like(mask)),
                                 cv2.COLOR_RGB2BGR))
    print(f"wrote figures for views {views} to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
