"""Trajectory evaluation: Sim(3) (Umeyama) alignment + APE statistics, a
copy of vista_slam_tpu/eval/traj.py (host numpy; matplotlib only for the
optional plot).

Self-contained replacement for the reference's evo dependency (reference:
vista_slam/eval/eval_traj.py:4-75 — PoseTrajectory3D association, Sim(3)
align with correct_scale=True, APE translation RMSE).
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Least-squares similarity aligning x -> y. x, y: [N, 3].
    Returns (R, t, c) with y ~= c * R @ x + t."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    mx, my = x.mean(0), y.mean(0)
    xc, yc = x - mx, y - my
    cov = yc.T @ xc / len(x)
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    R = u @ s @ vt
    c = 1.0
    if with_scale:
        var = (xc ** 2).sum() / len(x)
        c = float(np.trace(np.diag(d) @ s) / var) if var > 0 else 1.0
    t = my - c * R @ mx
    return R, t, c


def filter_valid_pairs(traj_est: np.ndarray, traj_ref: np.ndarray):
    """Drop pairs with NaN/Inf poses. The reference filters only the
    ground-truth side (eval_traj.py:14-21); non-finite estimates are dropped
    here too so a degenerate frame cannot abort the whole evaluation."""
    keep = [i for i in range(len(traj_ref))
            if np.isfinite(traj_ref[i]).all() and np.isfinite(traj_est[i]).all()]
    return np.asarray([traj_est[i] for i in keep]), np.asarray(
        [traj_ref[i] for i in keep])


def ape_statistics(traj_est, traj_ref, align: bool = True,
                   correct_scale: bool = True) -> dict:
    """APE on translation after optional Sim(3) alignment.

    traj_est / traj_ref: [N, 4, 4] cam-to-world poses.
    Returns evo-style statistics: rmse/mean/median/std/min/max/sse plus the
    alignment (R, t, s) and the aligned trajectory.
    """
    traj_est, traj_ref = filter_valid_pairs(np.asarray(traj_est), np.asarray(traj_ref))
    te = traj_est[:, :3, 3]
    tr = traj_ref[:, :3, 3]
    if align:
        R, t, c = umeyama_alignment(te, tr, with_scale=correct_scale)
    else:
        R, t, c = np.eye(3), np.zeros(3), 1.0
    te_aligned = (c * (R @ te.T)).T + t
    err = np.linalg.norm(te_aligned - tr, axis=-1)
    aligned = traj_est.copy()
    aligned[:, :3, 3] = te_aligned
    aligned[:, :3, :3] = np.einsum("ij,njk->nik", R, traj_est[:, :3, :3])
    return {
        "rmse": float(np.sqrt((err ** 2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "min": float(err.min()),
        "max": float(err.max()),
        "sse": float((err ** 2).sum()),
        "alignment": (R, t, c),
        "aligned_est": aligned,
        "errors": err,
    }


def full_traj_eval(traj_est, traj_ref, plot_dir: str | None = None,
                   plot_name: str = "traj"):
    """ATE pipeline + optional matplotlib plot (reference:
    eval_traj.py:62-75)."""
    stats = ape_statistics(traj_est, traj_ref)
    if plot_dir is not None:
        try:
            import os

            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            os.makedirs(plot_dir, exist_ok=True)
            fig, ax = plt.subplots(figsize=(8, 8))
            ref = np.asarray(traj_ref)[:, :3, 3]
            est = stats["aligned_est"][:, :3, 3]
            ax.plot(ref[:, 0], ref[:, 1], "--", color="gray", label="reference")
            sc = ax.scatter(est[:, 0], est[:, 1], c=stats["errors"], cmap="viridis", s=4)
            fig.colorbar(sc, ax=ax, label="APE [m]")
            ax.set_title(f"ATE RMSE {stats['rmse']:.4f} m")
            ax.legend()
            ax.set_aspect("equal")
            fig.savefig(os.path.join(plot_dir, f"{plot_name}.png"), dpi=120)
            plt.close(fig)
        except Exception:
            pass
    return stats
