"""Camera geometry, as in vista_slam_tpu/utils/geometry.py: intrinsics from
pointmaps (reference: vista_slam/utils/slam_utils.py:8-61) and the
closed-form rigid inverse the training losses use."""

from __future__ import annotations

import torch

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
