"""Render a PLY point cloud to PNG as a multi-view turntable (the port of
scripts/vis_ply.py; a matplotlib replacement for the reference's Open3D
PLY viewer). Needs matplotlib.

Usage:
  python -m vista_slam_tpu_torch.scripts.vis_ply --ply output/test/pointcloud.ply [--views 4]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils.pointcloud import read_ply
from ..utils.optional import require


def main(argv=None):
    matplotlib = require("matplotlib", "matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ap = argparse.ArgumentParser()
    ap.add_argument("--ply", required=True)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--max-points", type=int, default=300000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    pts, cols = read_ply(args.ply)
    if len(pts) > args.max_points:
        sel = np.random.default_rng(0).choice(len(pts), args.max_points, replace=False)
        pts, cols = pts[sel], (cols[sel] if cols is not None else None)

    fig = plt.figure(figsize=(5 * args.views, 5))
    for i in range(args.views):
        ax = fig.add_subplot(1, args.views, i + 1, projection="3d")
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.2,
                   c=(cols / 255.0 if cols is not None else "gray"))
        ax.view_init(elev=20, azim=360 * i / args.views)
        ax.set_axis_off()
    out = args.out or args.ply.rsplit(".", 1)[0] + ".png"
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
