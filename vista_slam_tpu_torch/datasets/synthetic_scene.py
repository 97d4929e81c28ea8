"""Synthetic textured-room renderer: consistent RGB-D + poses from a box
scene, for training/eval without external datasets.

Cameras move inside a textured axis-aligned box; each pixel ray intersects
the box walls, giving exact depth and a procedural texture color. Used to
(a) train the STA frontend end-to-end without downloading datasets and
(b) evaluate the full SLAM stack with known ground truth.
"""

from __future__ import annotations

import numpy as np


def _texture(points: np.ndarray, scale: float = 1.5) -> np.ndarray:
    """Procedural RGB texture over 3D wall points, in [0, 1]."""
    p = points * scale
    r = 0.5 + 0.25 * np.sin(2.1 * p[..., 0]) + 0.25 * np.sin(3.7 * p[..., 1] + 1.0)
    g = 0.5 + 0.25 * np.sin(2.9 * p[..., 1]) + 0.25 * np.sin(4.3 * p[..., 2] + 2.0)
    b = 0.5 + 0.25 * np.sin(3.3 * p[..., 2]) + 0.25 * np.sin(5.1 * p[..., 0] + 4.0)
    checker = ((np.floor(p[..., 0] * 2) + np.floor(p[..., 1] * 2)
                + np.floor(p[..., 2] * 2)) % 2) * 0.3
    return np.clip(np.stack([r, g, b], -1) * (0.7 + checker[..., None]), 0, 1)


class BoxScene:
    def __init__(self, half_size=(4.0, 4.0, 2.5)):
        self.lo = -np.asarray(half_size, np.float64)
        self.hi = np.asarray(half_size, np.float64)

    def render(self, pose: np.ndarray, K: np.ndarray, hw=(64, 64)):
        """pose: cam-to-world 4x4 (OpenCV convention, z forward).
        Returns (rgb float32 [H,W,3] in [0,1], depth float32 [H,W])."""
        h, w = hw
        ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
        dirs_cam = np.stack([(xs - K[0, 2]) / K[0, 0],
                             (ys - K[1, 2]) / K[1, 1],
                             np.ones_like(xs)], -1)
        R, t = pose[:3, :3], pose[:3, 3]
        dirs = dirs_cam @ R.T                      # [H,W,3] world ray dirs
        origin = t

        # slab intersection: smallest positive t where the ray EXITS the box
        with np.errstate(divide="ignore", invalid="ignore"):
            t_lo = (self.lo - origin) / dirs
            t_hi = (self.hi - origin) / dirs
        t_far = np.maximum(t_lo, t_hi)             # exit per axis
        t_hit = np.nanmin(t_far, axis=-1)          # first wall hit
        t_hit = np.maximum(t_hit, 1e-3)

        points = origin + dirs * t_hit[..., None]
        rgb = _texture(points).astype(np.float32)
        # depth = z in camera frame (dirs_cam z-component is 1)
        depth = t_hit.astype(np.float32)           # since |dir_cam.z| = 1
        return rgb, depth


def lookat_pose(eye, target, up=(0, 0, 1.0)):
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target, np.float64) - eye
    z /= np.linalg.norm(z)
    x = np.cross(z, np.asarray(up, np.float64))
    if np.linalg.norm(x) < 1e-6:
        x = np.cross(z, [0.0, 1.0, 0.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, eye
    return T


def orbit_trajectory(n, radius=2.0, height=0.0, target=(0, 0, 0)):
    poses = []
    for k in range(n):
        a = 2 * np.pi * k / n
        eye = [radius * np.cos(a), radius * np.sin(a), height]
        poses.append(lookat_pose(eye, target))
    return np.stack(poses)


class SyntheticSceneDataset:
    """In-memory view-graph dataset over a BoxScene (ComposableDataset-free:
    used directly by the trainer's loader through duck typing)."""

    def __init__(self, n_frames=64, hw=(64, 64), focal=48.0, neighbor_num=1,
                 loop_num=1, seed=0, radius=2.0):
        self.scene = BoxScene()
        self.hw = hw
        self.K = np.array([[focal, 0, hw[1] / 2], [0, focal, hw[0] / 2],
                           [0, 0, 1]], np.float32)
        self.poses = orbit_trajectory(n_frames, radius=radius)
        self.neighbor_num = neighbor_num
        self.loop_num = loop_num
        self.rng = np.random.default_rng(seed)
        self.n_frames = n_frames
        self._resolutions = [hw[::-1]]
        self._cache: dict[int, dict] = {}

    def set_epoch(self, epoch):
        pass

    @property
    def num_resolutions(self):
        return 1

    def __len__(self):
        return self.n_frames

    def view(self, idx: int) -> dict:
        if idx not in self._cache:
            pose = self.poses[idx % self.n_frames]
            rgb, depth = self.scene.render(pose, self.K, self.hw)
            h, w = self.hw
            ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                                 np.arange(w, dtype=np.float32), indexing="ij")
            x = (xs + 0.5 - self.K[0, 2]) * depth / self.K[0, 0]
            y = (ys + 0.5 - self.K[1, 2]) * depth / self.K[1, 1]
            self._cache[idx] = {
                "img": (rgb * 2 - 1).astype(np.float32),
                "rgb01": rgb,
                "gray": (rgb.mean(-1) * 255).astype(np.uint8),
                "depth": depth,
                "pts3d_cam": np.stack([x, y, depth], -1).astype(np.float32),
                "valid_mask": np.ones(self.hw, bool),
                "camera_pose": pose.astype(np.float32),
                "camera_intrinsics": self.K,
                "view_name": f"synth_{idx}",
            }
        return self._cache[idx]

    def __getitem__(self, idx):
        idx, _ = idx if isinstance(idx, tuple) else (idx, 0)
        center = int(idx) % self.n_frames
        neighbors = []
        for _ in range(2 * self.neighbor_num):
            off = int(self.rng.integers(1, 4)) * (1 if self.rng.random() < 0.5 else -1)
            neighbors.append(self.view((center + off) % self.n_frames))
        loops = [self.view((center + self.n_frames // 2
                            + int(self.rng.integers(-2, 3))) % self.n_frames)
                 for _ in range(self.loop_num)]
        return {"main_view": self.view(center), "neighbor_views": neighbors,
                "loop_views": loops}
