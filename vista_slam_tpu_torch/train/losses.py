"""Training losses for the STA frontend, in PyTorch.

The JAX package's criterion (vista_slam_tpu/train/losses.py), term for term:
  ConfLoss(PointRegrLoss(L21), alpha=0.4)
  + RelPoseLoss(trans_loss='l2', identity_constraint=True, conf=True, conf_alpha=0.05)
  + ReprojLoss(L21)
(reference: vista_slam/sta_model/train.py:128-134, losses_pcl.py,
losses_geo.py). Boolean-indexed reductions are mask-weighted means, as in
the JAX package. The correspondence sampler's gradient is plain autograd of
a gather (the JAX package's ``reproj_grad="f32"``); its TPU scatter
workarounds are not ported.

View dicts (all [B, ...] tensors):
  gt:   pts3d_cam [B,H,W,3], valid_mask [B,H,W] bool, camera_pose [B,4,4],
        camera_intrinsics [B,3,3]
  pred: pts3d [B,H,W,3], conf [B,H,W], pose [B,4,4] (relative, this view's
        frame -> other view's frame), pose_conf [B]
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.geometry import inv_se3


def masked_mean(x, mask, dim=None, eps=1e-8):
    mask = mask.to(x.dtype)
    if dim is None:
        return (x * mask).sum() / (mask.sum() + eps)
    return (x * mask).sum(dim) / (mask.sum(dim) + eps)


def l21(a, b):
    """Euclidean distance per point (reference L21Loss, losses_pcl.py:50-58)."""
    d = a - b
    d = torch.where(torch.isfinite(d), d, torch.zeros_like(d))
    return torch.linalg.vector_norm(d, dim=-1)


def joint_norm_factor(pts1, pts2, valid1, valid2, eps=1e-8):
    """'avg_dis' normalization factor over the union of two pointmaps
    (reference: utils/geometry.py:150-213)."""
    d1 = torch.linalg.vector_norm(pts1 * valid1[..., None], dim=-1)  # [B,H,W]
    d2 = torch.linalg.vector_norm(pts2 * valid2[..., None], dim=-1)
    num = d1.sum(dim=(1, 2)) + d2.sum(dim=(1, 2))
    den = valid1.sum(dim=(1, 2)) + valid2.sum(dim=(1, 2)) + eps
    return torch.clamp(num / den, min=eps)  # [B]


def pointmap_conf_loss(gt_main, gt_supp, pred_main, pred_supp, alpha=0.4):
    """ConfLoss(PointRegrLoss(L21)): jointly 'avg_dis'-normalized pointmaps,
    per-pixel euclidean error weighted by learned confidence minus
    alpha*log(conf) (reference: losses_pcl.py:138-278)."""
    vm = gt_main["valid_mask"]
    vs = gt_supp["valid_mask"]
    f_gt = joint_norm_factor(gt_main["pts3d_cam"], gt_supp["pts3d_cam"], vm, vs)
    f_pr = joint_norm_factor(pred_main["pts3d"], pred_supp["pts3d"], vm, vs)

    def term(gt_pts, pred_pts, conf, mask):
        d = l21(pred_pts / f_pr[:, None, None, None], gt_pts / f_gt[:, None, None, None])
        return masked_mean(d * conf - alpha * torch.log(conf), mask)

    return (term(gt_main["pts3d_cam"], pred_main["pts3d"], pred_main["conf"], vm)
            + term(gt_supp["pts3d_cam"], pred_supp["pts3d"], pred_supp["conf"], vs))


def _rot_geodesic(ra, rb):
    """Geodesic angle with the reference's clamp (losses_geo.py:166-168)."""
    tr = torch.diagonal(ra.transpose(-1, -2) @ rb, dim1=-2, dim2=-1).sum(-1)
    return torch.arccos(torch.clamp((tr - 1) / 2, -0.99999, 0.99999))


def rel_pose_loss(gt_main, gt_supp, pred_main, pred_supp, w_rot=1.0, w_trans=1.0,
                  identity_constraint=True, use_conf=True, conf_alpha=0.05):
    """RelPoseLoss with the 'l2' translation error: geodesic rotation error
    + normalized translation error vs GT, plus the forward-backward identity
    constraint, weighted by the pose confidence and SUMMED over the batch
    (reference: losses_geo.py:132-335)."""
    vm = gt_main["valid_mask"]
    vs = gt_supp["valid_mask"]
    f_gt = joint_norm_factor(gt_main["pts3d_cam"], gt_supp["pts3d_cam"], vm, vs)
    f_pr = joint_norm_factor(pred_main["pts3d"], pred_supp["pts3d"], vm, vs)

    gt_rel = inv_se3(gt_supp["camera_pose"]) @ gt_main["camera_pose"]
    gt_rot = gt_rel[:, :3, :3]
    gt_trans = gt_rel[:, :3, 3] / f_gt[:, None]
    ms_rot = pred_main["pose"][:, :3, :3]
    ms_trans = pred_main["pose"][:, :3, 3] / f_pr[:, None]
    sm_rot = pred_supp["pose"][:, :3, :3]
    sm_trans = pred_supp["pose"][:, :3, 3] / f_pr[:, None]

    rot_err = torch.abs(_rot_geodesic(ms_rot, gt_rot))
    dt = ms_trans - gt_trans
    trans_err = torch.linalg.vector_norm(
        torch.where(torch.isfinite(dt), dt, torch.zeros_like(dt)), dim=-1)
    if identity_constraint:
        eye = torch.eye(3, dtype=ms_rot.dtype, device=ms_rot.device).expand_as(ms_rot)
        rot_id = _rot_geodesic(ms_rot @ sm_rot, eye)
        back = torch.einsum("bij,bj->bi", ms_rot, sm_trans)
        rot_err = rot_err + rot_id
        trans_err = trans_err + torch.linalg.vector_norm(ms_trans + back, dim=-1)

    per_sample = w_rot * rot_err + w_trans * trans_err
    if use_conf:
        conf = torch.clamp(pred_main["pose_conf"], 1e-6, 1.0)
        return torch.sum(per_sample * conf - conf_alpha * torch.log(conf))
    return torch.sum(per_sample)


def _nearest_indices(grid_xy, H, W):
    """grid in [-1,1] xy [B,H,W,2] -> (flat row indices [B,HW], in-bounds
    mask [B,H,W]) for nearest sampling (torch grid_sample mode='nearest',
    align_corners=True rounding: half to even)."""
    gx = (grid_xy[..., 0] + 1) * 0.5 * (W - 1)
    gy = (grid_xy[..., 1] + 1) * 0.5 * (H - 1)
    ix = torch.round(gx).to(torch.int64)
    iy = torch.round(gy).to(torch.int64)
    valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    flat = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
    return flat.reshape(grid_xy.shape[0], -1), valid


def _grid_sample_nearest(img, grid_xy):
    """img [B,H,W,C], grid in [-1,1] xy [B,H,W,2] -> nearest sample with zero
    padding (matches torch grid_sample mode='nearest'); the gradient is
    autograd of the gather."""
    B, H, W, C = img.shape
    flat, valid = _nearest_indices(grid_xy, H, W)
    out = torch.gather(img.reshape(B, H * W, C), 1, flat[..., None].expand(-1, -1, C))
    out = out.reshape(B, H, W, C)
    return torch.where(valid[..., None], out, torch.zeros_like(out)), valid


class Correspondence(NamedTuple):
    grid: torch.Tensor   # [B,H,W,2] in [-1,1]
    valid: torch.Tensor  # [B,H,W]


def gt_correspondence(gt_src, gt_tgt, depth_tol=0.05) -> Correspondence:
    """Project GT source points into the target view and build the sampling
    grid + visibility mask (reference: losses_geo.py:18-63)."""
    src_pts = gt_src["pts3d_cam"]
    B, H, W, _ = src_pts.shape
    rel = inv_se3(gt_tgt["camera_pose"]) @ gt_src["camera_pose"]
    pts = src_pts.reshape(B, -1, 3) @ rel[:, :3, :3].transpose(1, 2) + rel[:, None, :3, 3]
    proj = pts @ gt_tgt["camera_intrinsics"].transpose(1, 2)
    z = proj[..., 2:3]
    uv = proj[..., :2] / torch.where(torch.abs(z) > 1e-12, z, torch.full_like(z, 1e-12))
    x = 2 * uv[..., 0] / (W - 1) - 1
    y = 2 * uv[..., 1] / (H - 1) - 1
    grid = torch.stack([x, y], -1).reshape(B, H, W, 2)

    # one gather for both GT channels (target z + validity), as the JAX package
    packed = torch.cat([gt_tgt["pts3d_cam"][..., 2:3],
                        gt_tgt["valid_mask"][..., None].to(torch.float32)], dim=-1)
    sel, inb = _grid_sample_nearest(packed, grid)
    visible = torch.abs(pts.reshape(B, H, W, 3)[..., 2] - sel[..., 0]) < depth_tol
    valid = gt_src["valid_mask"] & (sel[..., 1] >= 1.0) & visible & inb
    return Correspondence(grid, valid)


def reproj_loss(gt_main, gt_supp, pred_main, pred_supp):
    """ReprojLoss(L21): predicted main points mapped through the predicted
    relative pose must agree with the supported view's prediction sampled at
    GT correspondences, both scaled by the prediction's joint norm factor
    (reference: losses_geo.py:11-129)."""
    corr = gt_correspondence(gt_main, gt_supp)
    B, H, W, _ = pred_main["pts3d"].shape
    both = torch.cat([pred_main["pts3d"].reshape(B, -1, 3),
                      pred_supp["pts3d"].reshape(B, -1, 3)], 1)
    vmask = torch.cat([gt_main["valid_mask"].reshape(B, -1),
                       gt_supp["valid_mask"].reshape(B, -1)], 1)
    scale = masked_mean(torch.linalg.vector_norm(both * vmask[..., None], dim=-1), vmask, dim=1)
    scale = torch.where(torch.isfinite(scale), scale, torch.ones_like(scale))[:, None, None, None]

    supp_sel, _ = _grid_sample_nearest(pred_supp["pts3d"], corr.grid)
    rel = pred_main["pose"]
    pts = pred_main["pts3d"].reshape(B, -1, 3) @ rel[:, :3, :3].transpose(1, 2) \
        + rel[:, None, :3, 3]
    d = l21(pts.reshape(B, H, W, 3) / scale, supp_sel / scale)
    return masked_mean(d, corr.valid)


def sta_criterion(gt_main, gt_supports, pred_mains, pred_supports, *,
                  conf_alpha=0.4, pose_conf_alpha=0.05):
    """The full training criterion summed over support views (reference
    default: train.py:128-130). Returns (loss, details)."""
    total = 0.0
    details = {}
    for i in range(len(gt_supports)):
        lp = pointmap_conf_loss(gt_main, gt_supports[i], pred_mains[i],
                                pred_supports[i], alpha=conf_alpha)
        lr = rel_pose_loss(gt_main, gt_supports[i], pred_mains[i],
                           pred_supports[i], conf_alpha=pose_conf_alpha)
        lj = reproj_loss(gt_main, gt_supports[i], pred_mains[i], pred_supports[i])
        total = total + lp + lr + lj
        details[f"pts_{i}"] = lp
        details[f"pose_{i}"] = lr
        details[f"reproj_{i}"] = lj
    return total, details
