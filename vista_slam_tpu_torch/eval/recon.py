"""Dense reconstruction evaluation: Sim(3) init + ICP refine + clipped
chamfer RMSE, a copy of vista_slam_tpu/eval/recon.py (host numpy / scipy).

Replaces the reference's open3d/pykdtree stack (reference:
vista_slam/eval/eval_recon.py:89-206) with scipy cKDTree + a point-to-point
ICP: unproject scaled depths to world clouds, apply the trajectory-alignment
similarity, voxel-downsample, ICP refine, then accuracy / completeness /
chamfer RMSE with errors clipped at ``max_error`` (0.5 m).
"""

from __future__ import annotations

import os

import numpy as np
from scipy.spatial import cKDTree

from ..utils.pointcloud import unproject_views


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Average points within each voxel (matches open3d voxel_down_sample)."""
    if len(points) == 0:
        return points
    keys = np.floor(points / voxel).astype(np.int64)
    # unique voxel -> mean of member points
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((len(counts), 3), np.float64)
    np.add.at(sums, inv, points)
    return (sums / counts[:, None]).astype(np.float32)


def icp_point_to_point(src: np.ndarray, dst: np.ndarray, max_dist: float = 0.1,
                       iters: int = 30, tol: float = 1e-6) -> np.ndarray:
    """Rigid point-to-point ICP; returns a 4x4 transform applied to src."""
    T = np.eye(4)
    cur = src.copy()
    tree = cKDTree(dst)
    prev_err = np.inf
    for _ in range(iters):
        dist, idx = tree.query(cur, distance_upper_bound=max_dist)
        ok = np.isfinite(dist)
        if ok.sum() < 10:
            break
        p = cur[ok]
        q = dst[idx[ok]]
        mp, mq = p.mean(0), q.mean(0)
        H = (p - mp).T @ (q - mq)
        u, _, vt = np.linalg.svd(H)
        d = np.sign(np.linalg.det(vt.T @ u.T))
        R = vt.T @ np.diag([1, 1, d]) @ u.T
        t = mq - R @ mp
        cur = (R @ cur.T).T + t
        Ti = np.eye(4)
        Ti[:3, :3] = R
        Ti[:3, 3] = t
        T = Ti @ T
        err = float(dist[ok].mean())
        if abs(prev_err - err) < tol:
            break
        prev_err = err
    return T


def chamfer_rmse(ref: np.ndarray, est: np.ndarray, max_error: float = 0.5):
    """Clipped symmetric chamfer (reference: eval_recon.py:89-106).
    Returns (chamfer, rmse_accuracy, rmse_completeness)."""
    tree_ref = cKDTree(ref)
    tree_est = cKDTree(est)
    d_acc, _ = tree_ref.query(est)   # est -> ref: accuracy
    d_comp, _ = tree_est.query(ref)  # ref -> est: completeness
    d_acc = np.clip(d_acc, 0, max_error)
    d_comp = np.clip(d_comp, 0, max_error)
    rmse_acc = float(np.sqrt((d_acc ** 2).mean()))
    rmse_comp = float(np.sqrt((d_comp ** 2).mean()))
    return 0.5 * rmse_acc + 0.5 * rmse_comp, rmse_acc, rmse_comp


def eval_recon(gt_depths, gt_poses, gt_intri, est_depths, est_poses, est_intris,
               est_masks, rel_R, rel_t, rel_s, voxel: float = 0.05,
               max_error: float = 0.5, icp_max_dist: float = 0.1):
    """Full reconstruction comparison (reference: eval_recon.py:108-178)."""
    gt_world = unproject_views(np.asarray(gt_depths), _bcast_K(gt_intri, len(gt_depths)),
                               np.asarray(gt_poses))
    est_world = unproject_views(np.asarray(est_depths), np.asarray(est_intris),
                                np.asarray(est_poses))
    gt_mask = np.asarray(gt_depths) > 0
    est_mask = np.asarray(est_masks, bool) & gt_mask
    gt_pts = gt_world[gt_mask].astype(np.float64)
    est_pts = est_world[est_mask].astype(np.float64)
    gt_pts = gt_pts[np.isfinite(gt_pts).all(-1)]
    est_pts = est_pts[np.isfinite(est_pts).all(-1)]

    est_pts = (rel_s * (np.asarray(rel_R) @ est_pts.T)).T + np.asarray(rel_t).reshape(3)

    est_down = voxel_downsample(est_pts, voxel)
    gt_down = voxel_downsample(gt_pts, voxel)
    T = icp_point_to_point(est_down, gt_down, max_dist=icp_max_dist)
    est_pts = (T[:3, :3] @ est_pts.T).T + T[:3, 3]

    chamfer, rmse_acc, rmse_comp = chamfer_rmse(gt_pts, est_pts, max_error)
    return rmse_acc, rmse_comp, chamfer, gt_pts, est_pts


def _bcast_K(K, n):
    K = np.asarray(K)
    return np.broadcast_to(K, (n, 3, 3)) if K.ndim == 2 else K


def eval_recon_from_saved_data(output_folder: str, rel_est_gt=None):
    """Evaluate from the artifact directory written by
    OnlineSLAM.save_data_all (reference: eval_recon.py:181-206)."""
    from .traj import ape_statistics

    def load(name):
        return np.load(os.path.join(output_folder, name))

    depths = load("depths.npy")
    scales = load("scales.npy")
    confs_z = np.load(os.path.join(output_folder, "confs.npz"))
    confs, conf_thres = confs_z["confs"], float(confs_z["thres"])
    poses = load("trajectory.npy")
    intris = load("intrinsics.npy")
    gt_depths = load("gt_depths.npy")
    gt_poses = load("gt_poses.npy")
    gt_intri = load("gt_intrinsics.npy")

    est_depths = depths * scales.reshape(-1, 1, 1)
    est_masks = confs > conf_thres

    if rel_est_gt is not None:
        rel_R, rel_t, rel_s = rel_est_gt
    else:
        stats = ape_statistics(poses, gt_poses)
        rel_R, rel_t, rel_s = stats["alignment"]

    return eval_recon(gt_depths, gt_poses, gt_intri, est_depths, poses, intris,
                      est_masks, rel_R, rel_t, rel_s)
