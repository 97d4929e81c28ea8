"""Point-cloud export utilities (replaces the reference's open3d dependency
for PLY writing; reference: slam.py:397-412)."""

from __future__ import annotations

import numpy as np


def unproject_views(depths: np.ndarray, intrinsics: np.ndarray,
                    poses: np.ndarray) -> np.ndarray:
    """depths [N,H,W], intrinsics [N,3,3], poses [N,4,4] (cam->world)
    -> world points [N,H,W,3]."""
    n, h, w = depths.shape
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)  # [HW,3]
    k_inv = np.linalg.inv(intrinsics)  # [N,3,3]
    rays = np.einsum("nij,pj->npi", k_inv, pix)  # [N,HW,3]
    cam = rays * depths.reshape(n, -1, 1)
    world = np.einsum("nij,npj->npi", poses[:, :3, :3], cam) + poses[:, None, :3, 3]
    return world.reshape(n, h, w, 3)


def write_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None):
    """Binary little-endian PLY writer. points [M,3] float; colors [M,3] in
    [0,1] or uint8."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    m = len(points)
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors).reshape(-1, 3)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {m}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if has_color:
            rec = np.zeros(m, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec["xyz"] = points
            rec["rgb"] = colors
            f.write(rec.tobytes())
        else:
            f.write(points.astype("<f4").tobytes())


def read_ply(path: str):
    """Minimal PLY reader for the files written by write_ply (and ASCII)."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        assert line == b"ply"
        fmt = None
        n = 0
        props = []
        while True:
            line = f.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1]
            elif line.startswith(b"element vertex"):
                n = int(line.split()[-1])
            elif line.startswith(b"property"):
                props.append(line.split()[-1].decode())
            elif line == b"end_header":
                break
        has_color = "red" in props
        if fmt == b"binary_little_endian":
            dt = [("xyz", "<f4", 3)] + ([("rgb", "u1", 3)] if has_color else [])
            rec = np.frombuffer(f.read(), dtype=np.dtype(dt), count=n)
            pts = rec["xyz"].copy()
            cols = rec["rgb"].copy() if has_color else None
        else:
            data = np.loadtxt(f, max_rows=n)
            pts = data[:, :3].astype(np.float32)
            cols = data[:, 3:6].astype(np.uint8) if has_color else None
    return pts, cols
