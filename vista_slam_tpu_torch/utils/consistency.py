"""Geometric cross-view consistency checks, as in
vista_slam_tpu/utils/consistency.py (reference: vista_slam/utils/
slam_utils.py:193-419, compute_symmetric_geo_valid_mask and
view_consistency_check). Unused on the online path; for offline filtering
and analysis. Depths are z-depths; samples are nearest-pixel.
"""

from __future__ import annotations

import torch

from ..ops.linalg import adjugate_inv3
from .geometry import inv_se3
from .image_ops import pixel_grid


def _project(pts: torch.Tensor, K: torch.Tensor):
    uv = pts @ K.transpose(-1, -2)
    z = uv[..., 2:3]
    return uv[..., :2] / torch.where(z.abs() > 1e-8, z, 1e-8), pts[..., 2]


def _sample_nearest(depth: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """depth [H,W] at the rounded (u, v) (half to even), with validity."""
    H, W = depth.shape
    ui = torch.round(u).long()
    vi = torch.round(v).long()
    valid = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    return depth[vi.clamp(0, H - 1), ui.clamp(0, W - 1)], valid


def _nanmax(x: torch.Tensor) -> torch.Tensor:
    m = torch.where(torch.isnan(x), -torch.inf, x).max()
    return torch.where(torch.isnan(x).all(), torch.nan, m)


def symmetric_geo_valid_mask(depths: torch.Tensor, K: torch.Tensor,
                             relative_pose: torch.Tensor) -> torch.Tensor:
    """depths [2,H,W], shared K [3,3], relative_pose [4,4] (cam1 -> cam2) ->
    [2,H,W] masks of mutually consistent pixels, each direction thresholded
    at twice its median error over the valid samples (reference:
    slam_utils.py:269-343)."""
    H, W = depths.shape[1:]
    pix = pixel_grid(H, W, depths.dtype, depths.device).reshape(-1, 3)
    rays = pix @ adjugate_inv3(K).T

    def one_direction(depth_src, depth_tgt, T):
        pts = rays * depth_src.reshape(-1, 1)
        pts = pts @ T[:3, :3].T + T[:3, 3]
        uv, z = _project(pts, K)
        d_tgt, valid = _sample_nearest(depth_tgt, uv[..., 0], uv[..., 1])
        err = (d_tgt - z).abs()
        masked = torch.where(valid, err, _nanmax(err) + 1.0)
        n_valid = max(int(valid.sum()), 1)
        thres = 2.0 * torch.sort(masked).values[(n_valid - 1) // 2]
        return (err < thres) & valid

    m1 = one_direction(depths[0], depths[1], relative_pose)
    m2 = one_direction(depths[1], depths[0], inv_se3(relative_pose))
    return torch.stack([m1.reshape(H, W), m2.reshape(H, W)])


def view_consistency_count(depths: torch.Tensor, intrinsics: torch.Tensor,
                           poses: torch.Tensor, threshold: float = 0.05,
                           window: int = 4) -> torch.Tensor:
    """Per-pixel count of the views j in i-window ... i+window (indices
    clipped to the sequence, so a view near an end is counted once for each
    clipped offset, as in the JAX package) whose depth agrees after
    reprojection (reference: slam_utils.py:346-419). depths [N,H,W],
    intrinsics [N,3,3], poses [N,4,4] camera-to-world -> int32 [N,H,W]."""
    N, H, W = depths.shape
    pix = pixel_grid(H, W, depths.dtype, depths.device).reshape(-1, 3)
    offsets = torch.arange(-window, window + 1, device=depths.device)
    counts = []
    for i in range(N):
        cam = (pix @ adjugate_inv3(intrinsics[i]).T) * depths[i].reshape(-1, 1)
        world = cam @ poses[i, :3, :3].T + poses[i, :3, 3]
        js = (i + offsets).clamp(0, N - 1)
        T_inv = inv_se3(poses[js])                                  # [J,4,4]
        cam_j = world[None] @ T_inv[:, :3, :3].transpose(-1, -2) + T_inv[:, None, :3, 3]
        uv, z = _project(cam_j, intrinsics[js])
        agree = torch.zeros((H * W,), dtype=torch.int32, device=depths.device)
        for k, j in enumerate(js.tolist()):
            d_j, valid = _sample_nearest(depths[j], uv[k, :, 0], uv[k, :, 1])
            ok = ((d_j - z[k]).abs() < threshold) & (z[k] > 0) & valid & (j != i)
            agree += ok.to(torch.int32)
        counts.append(agree.reshape(H, W))
    return torch.stack(counts)
