"""Visualize saved SLAM results: trajectory, camera frusta, view-graph edges
and the fused point cloud (the port of scripts/vis_slam_results.py; a
matplotlib replacement for the reference's Open3D viewer). Reads the
directory that ``OnlineSLAM.save_data_all`` writes and saves a static PNG
(and, with --show, opens a window). Needs matplotlib.

Usage:
  python -m vista_slam_tpu_torch.scripts.vis_slam_results --result-dir output/test
      [--show] [--max-points 200000]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils.pointcloud import read_ply
from ..utils.optional import require


def frustum_lines(pose, scale=0.05):
    corners = np.array([
        [0, 0, 0], [-1, -0.75, 1.5], [1, -0.75, 1.5], [1, 0.75, 1.5], [-1, 0.75, 1.5],
    ]) * scale
    pts = corners @ pose[:3, :3].T + pose[:3, 3]
    edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    return [(pts[a], pts[b]) for a, b in edges]


def view_graph_pairs(vg) -> list[tuple[int, int]]:
    """The (view, neighbour) pairs of a saved ``view_graph.npz``."""
    if "edges" in vg.files:
        return [tuple(e) for e in vg["edges"]]
    graph = vg["view_graph"].item()  # legacy pickled-dict schema
    return [(v, u) for v, ns in graph.items() for u in ns]


def main(argv=None):
    matplotlib = require("matplotlib", "matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    ap = argparse.ArgumentParser()
    ap.add_argument("--result-dir", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--max-points", type=int, default=200000)
    ap.add_argument("--show", action="store_true")
    args = ap.parse_args(argv)

    poses = np.load(os.path.join(args.result_dir, "trajectory.npy"))
    fig = plt.figure(figsize=(12, 10))
    ax = fig.add_subplot(projection="3d")

    ply = os.path.join(args.result_dir, "pointcloud.ply")
    if os.path.exists(ply):
        pts, cols = read_ply(ply)
        if len(pts) > args.max_points:
            sel = np.random.default_rng(0).choice(len(pts), args.max_points,
                                                  replace=False)
            pts = pts[sel]
            cols = cols[sel] if cols is not None else None
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.3,
                   c=(cols / 255.0 if cols is not None else "gray"), alpha=0.6)

    traj = poses[:, :3, 3]
    ax.plot(traj[:, 0], traj[:, 1], traj[:, 2], "g-", lw=2, label="trajectory")

    lines = []
    for pose in poses[:: max(len(poses) // 50, 1)]:
        lines.extend(frustum_lines(pose))
    ax.add_collection3d(Line3DCollection(lines, colors="tab:blue", lw=0.6))

    vg_path = os.path.join(args.result_dir, "view_graph.npz")
    if os.path.exists(vg_path):
        vg = np.load(vg_path, allow_pickle=True)
        loop_min = int(vg["loop_min_dist"])
        edge_lines, edge_cols = [], []
        for v, u in view_graph_pairs(vg):
            if u < 0 or u >= len(poses):
                continue
            edge_lines.append((traj[int(v)], traj[int(u)]))
            edge_cols.append("tab:orange" if abs(int(v) - int(u)) > loop_min
                             else "tab:blue")
        ax.add_collection3d(Line3DCollection(edge_lines, colors=edge_cols,
                                             lw=0.4, alpha=0.5))

    ax.set_title(f"{args.result_dir} — {len(poses)} keyframes")
    ax.legend()
    out = args.out or os.path.join(args.result_dir, "vis_results.png")
    fig.savefig(out, dpi=130)
    print(f"wrote {out}")
    if args.show:
        plt.show()
    plt.close(fig)
    return out


if __name__ == "__main__":
    main()
