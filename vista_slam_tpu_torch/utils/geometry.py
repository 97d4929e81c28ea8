"""Camera geometry, as in vista_slam_tpu/utils/geometry.py (reference:
vista_slam/utils/slam_utils.py:8-190): intrinsics from pointmaps, depth <->
pointcloud conversion, relative scale, and the closed-form rigid inverse."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.linalg import adjugate_inv3
from .image_ops import pixel_grid


def inv_se3(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of rigid [..., 4, 4] transforms:
    inv([R t; 0 1]) = [R^T -R^T t; 0 1]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3])
    top = torch.cat([Rt, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=T.dtype, device=T.device)
    return torch.cat([top, bottom.expand(T.shape[:-2] + (1, 4))], dim=-2)


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    r = a / b
    return torch.where(torch.isfinite(r), r, torch.zeros_like(r))


def estimate_intrinsics_shared(pts3d: torch.Tensor, conf: torch.Tensor) -> torch.Tensor:
    """Confidence-weighted least-squares focal estimate shared over a set of
    views, with cx, cy fixed at the image centre.

    pts3d [..., B, H, W, 3], conf [..., B, H, W] -> K [..., 3, 3]: the fit
    pools the B views; leading dimensions are independent sets (the frontend
    passes one set of two views per decoded pair).
    """
    *lead, B, H, W, _ = pts3d.shape
    cx, cy = W / 2.0, H / 2.0
    grid = pixel_grid(H, W, pts3d.dtype, pts3d.device)
    u = (grid[..., 0] - cx).reshape(-1).repeat(B)
    v = (grid[..., 1] - cy).reshape(-1).repeat(B)
    pts = pts3d.reshape(*lead, B * H * W, 3)
    w = torch.clamp_min(conf.reshape(*lead, B * H * W), 1e-6)
    xz = _safe_div(pts[..., 0], pts[..., 2])
    yz = _safe_div(pts[..., 1], pts[..., 2])
    fx = (w * xz * u).sum(-1) / torch.clamp_min((w * xz * xz).sum(-1), 1e-12)
    fy = (w * yz * v).sum(-1) / torch.clamp_min((w * yz * yz).sum(-1), 1e-12)
    K = torch.zeros(tuple(lead) + (3, 3), dtype=pts3d.dtype, device=pts3d.device)
    K[..., 0, 0] = fx
    K[..., 1, 1] = fy
    K[..., 0, 2] = cx
    K[..., 1, 2] = cy
    K[..., 2, 2] = 1.0
    return K


def estimate_intrinsics_batched(pts3d: torch.Tensor, conf: torch.Tensor) -> torch.Tensor:
    """Per-image focal estimate: [B,H,W,3], [B,H,W] -> K [B,3,3]
    (reference: slam_utils.py:63-79): the shared fit over sets of one view."""
    return estimate_intrinsics_shared(pts3d[:, None], conf[:, None])


def _pixel_rays(K: torch.Tensor, n: int, h: int, w: int, dtype) -> torch.Tensor:
    """Per-pixel K^-1 rays [n, H, W, 3]; K is [3,3] shared or [n,3,3]."""
    pix = pixel_grid(h, w, dtype, K.device).reshape(-1, 3)  # [HW, 3]
    if K.dim() == 2:
        return (pix @ adjugate_inv3(K).T).reshape(1, h, w, 3).expand(n, h, w, 3)
    return torch.einsum("nij,pj->npi", adjugate_inv3(K), pix).reshape(n, h, w, 3)


def depth_to_pointcloud(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Unproject depth maps: [N,H,W] + K ([3,3] or [N,3,3]) -> [N,H,W,3]
    (reference: slam_utils.py:82-121)."""
    N, H, W = depth.shape
    return _pixel_rays(K, N, H, W, depth.dtype) * depth[..., None]


def depth_from_pointcloud(pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """RAY-LENGTH depth (the projection onto the unit ray), not z-depth:
    [B,H,W,3] -> [B,H,W], up to ~15% above pts[..., 2] at image corners. It
    matches the reference's dot-product definition (slam_utils.py:124-165);
    the pointmap store and the consistency checks use z-depth, so this is
    not the inverse of depth_to_pointcloud."""
    B, H, W, _ = pts.shape
    rays = _pixel_rays(K, B, H, W, pts.dtype)
    rays = rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)
    return (pts * rays).sum(-1)


def estimate_scale(d_i, d_j, c_i, c_j) -> torch.Tensor:
    """Least-squares scale s with D_j ~= s * D_i under dual confidence
    weights (reference: slam_utils.py:168-190)."""
    w = torch.clamp_min(c_i * c_j, 1e-6)
    return (w * d_i * d_j).sum() / torch.clamp_min((w * d_i * d_i).sum(), 1e-12)


def estimate_scale_np(d_i, d_j, c_i, c_j) -> float:
    """Host (numpy) version for per-node graph bookkeeping."""
    w = np.maximum(c_i.astype(np.float64) * c_j.astype(np.float64), 1e-6)
    return float(np.sum(w * d_i * d_j) / max(np.sum(w * d_i * d_i), 1e-12))
