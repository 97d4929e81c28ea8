"""Render a fly-through video along the estimated trajectory by splatting
the fused point cloud into each camera (the port of
scripts/render_flythrough.py; a replacement for the reference's Open3D
fly-through renderer). Reads the directory that ``OnlineSLAM.save_data_all``
writes. Needs OpenCV (the video writer).

Usage:
  python -m vista_slam_tpu_torch.scripts.render_flythrough --result-dir output/test \
      [--out video.mp4] [--interp 3]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils.pointcloud import read_ply
from ..utils.optional import require


def splat(points, colors, pose, K, hw):
    h, w = hw
    Tinv = np.linalg.inv(pose)
    cam = points @ Tinv[:3, :3].T + Tinv[:3, 3]
    z = cam[:, 2]
    front = z > 0.05
    cam, z = cam[front], z[front]
    col = colors[front]
    uv = cam @ K.T
    u = (uv[:, 0] / uv[:, 2]).astype(np.int32)
    v = (uv[:, 1] / uv[:, 2]).astype(np.int32)
    ok = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    u, v, z, col = u[ok], v[ok], z[ok], col[ok]
    order = np.argsort(-z)  # far first so near overwrites
    img = np.zeros((h, w, 3), np.uint8)
    img[v[order], u[order]] = col[order]
    return img


def interp_poses(poses, k):
    if k <= 1:
        return poses
    out = []
    for a, b in zip(poses[:-1], poses[1:]):
        for t in np.linspace(0, 1, k, endpoint=False):
            T = a.copy()
            T[:3, 3] = (1 - t) * a[:3, 3] + t * b[:3, 3]
            out.append(T)
    out.append(poses[-1])
    return np.stack(out)


def main(argv=None):
    cv2 = require("cv2", "OpenCV")

    ap = argparse.ArgumentParser()
    ap.add_argument("--result-dir", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--interp", type=int, default=3)
    ap.add_argument("--size", type=int, nargs=2, default=(480, 640))
    ap.add_argument("--fps", type=int, default=15)
    args = ap.parse_args(argv)

    poses = np.load(os.path.join(args.result_dir, "trajectory.npy"))
    intr = np.load(os.path.join(args.result_dir, "intrinsics.npy"))[0]
    pts, cols = read_ply(os.path.join(args.result_dir, "pointcloud.ply"))
    if cols is None:
        cols = np.full((len(pts), 3), 200, np.uint8)

    h, w = args.size
    scale = np.array([w / 224.0, h / 224.0, 1.0])[:, None]
    K = intr * scale
    K[2, 2] = 1.0

    out_path = args.out or os.path.join(args.result_dir, "flythrough.mp4")
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), args.fps, (w, h))
    try:
        for pose in interp_poses(poses, args.interp):
            frame = splat(pts, cols, pose, K, (h, w))
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    finally:
        writer.release()
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    main()
