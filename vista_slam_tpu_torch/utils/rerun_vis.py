"""Live 3D visualization via Rerun, gracefully gated when unavailable.

Capability-matched to the reference's streaming visualization (reference:
run.py:13-90, run_live.py:61-82): per-view camera transform + pinhole +
colored local pointcloud + pointmap image, with incremental or show-all
updates. When the ``rerun`` package is not installed every call is a no-op
and a single warning is emitted.
"""

from __future__ import annotations

import numpy as np

from .logging import Channel, log
from .pointcloud import unproject_views

try:
    import rerun as rr
except ImportError:  # pragma: no cover
    rr = None

_warned = False


def available() -> bool:
    global _warned
    if rr is None and not _warned:
        log("rerun not installed — live visualization disabled", Channel.WARNING)
        _warned = True
    return rr is not None


def init(name: str, save_path: str | None = None, url: str | None = None):
    if not available():
        return
    rr.init(name, spawn=False)
    if save_path:
        rr.save(save_path)
    if url:
        rr.connect_grpc(url)
    rr.log("/world", rr.Transform3D())


def set_time(t: int):
    if available():
        rr.set_time("index", sequence=t)


def log_view(topic: str, pose: np.ndarray, img_hwc: np.ndarray,
             pts3d: np.ndarray, K: np.ndarray | None, mask: np.ndarray,
             downsample: float = 1.0):
    """img_hwc in [-1, 1]; pts3d [H,W,3] camera-frame points."""
    if not available():
        return
    h, w = img_hwc.shape[:2]
    if K is None:
        K = np.array([[w / 2, 0, w / 2], [0, h / 2, h / 2], [0, 0, 1]], np.float32)
    img = (img_hwc + 1.0) / 2.0
    rr.log(f"world/est/{topic}",
           rr.Transform3D(translation=pose[:3, 3], mat3x3=pose[:3, :3]))
    rr.log(f"world/est/{topic}/cam",
           rr.Pinhole(resolution=[h, w], image_from_camera=K,
                      camera_xyz=rr.ViewCoordinates.RDF))
    pts = pts3d[mask]
    cols = img[mask]
    if 0 < downsample < 1.0 and len(pts):
        sel = np.random.choice(len(pts), int(len(pts) * downsample), replace=False)
        pts, cols = pts[sel], cols[sel]
    rr.log(f"world/est/{topic}/points", rr.Points3D(pts, colors=cols, radii=0.002))
    rr.log(f"world/est/{topic}/cam", rr.Image((img * 255).astype(np.uint8)))


def log_slam_views(slam, show_all: bool, max_views: int | None = None):
    """Stream current SLAM state (reference: run.py:60-90)."""
    if not available():
        return
    if show_all:
        to_show = list(range(slam.view_num))
        for v in to_show:
            rr.log(f"world/est/cam_{v}", rr.Clear(recursive=True))
        if max_views:
            to_show = to_show[-max_views:]
    else:
        to_show = [slam.view_num - 1]
    for v in to_show:
        view = slam.get_view(v)
        pcl = unproject_views(view["depth"][None], view["intri"][None],
                              np.eye(4, dtype=np.float32)[None])[0]
        mask = pcl[:, :, 2] > 0
        log_view(f"cam_{v}", view["pose"], slam.imgs[v], pcl, view["intri"], mask)


def disconnect():
    if available():
        rr.disconnect()
