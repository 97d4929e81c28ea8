"""Frame preprocessing: principal-point-centered crop + Lanczos rescale with
intrinsics bookkeeping.

Semantics match the reference's eval-time pipeline (reference:
vista_slam/datasets/base/base_view_graph_dataset.py:116-211 and
vista_slam/utils/cropping.py:54-122): center a symmetric window on the
principal point (respecting an edge margin), Lanczos-resize so the shorter
side covers the target, then center-crop to the target resolution, adjusting
the intrinsics through COLMAP<->OpenCV pixel-center conventions.

Outputs use HWC numpy arrays (the TPU-native layout) rather than torch CHW:
rgb float32 in [-1, 1], gray uint8, depth float32 (meters).
"""

from __future__ import annotations

import numpy as np

try:  # image decoding and resampling only: the module imports without them
    import PIL.Image
except ImportError:  # pragma: no cover
    PIL = None

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def opencv_to_colmap_intrinsics(K):
    K = K.copy()
    K[:2, 2] += 0.5
    return K


def colmap_to_opencv_intrinsics(K):
    K = K.copy()
    K[:2, 2] -= 0.5
    return K


def _crop(image, depth, K, bbox):
    l, t, r, b = bbox
    image = image.crop((l, t, r, b))
    if depth is not None:
        depth = depth[t:b, l:r]
    if K is not None:
        K = K.copy()
        K[0, 2] -= l
        K[1, 2] -= t
    return image, depth, K


def _rescale(image, depth, K, out_res):
    in_res = np.array(image.size)
    scale = max(np.array(out_res) / in_res) + 1e-8
    new_res = np.floor(in_res * scale).astype(int)
    image = image.resize(new_res, resample=getattr(PIL.Image, "Resampling", PIL.Image).LANCZOS)
    if depth is not None:
        depth = cv2.resize(depth, tuple(new_res), interpolation=cv2.INTER_NEAREST)
    if K is not None:
        Kc = opencv_to_colmap_intrinsics(K)
        Kc[:2, :] *= scale
        K = colmap_to_opencv_intrinsics(Kc)
    return image, depth, K


def _center_crop_to(image, depth, K, out_res):
    Kc = opencv_to_colmap_intrinsics(K)
    margins = np.asarray(image.size) - np.asarray(out_res)
    Kc2 = Kc.copy()
    Kc2[:2, 2] -= 0.5 * margins
    K2 = colmap_to_opencv_intrinsics(Kc2)
    l, t = np.int32(np.round(K[:2, 2] - K2[:2, 2]))
    return _crop(image, depth, K, (l, t, l + out_res[0], t + out_res[1]))


def crop_resize(rgb: np.ndarray, depth: np.ndarray | None, K: np.ndarray | None,
                resolution=(224, 224), w_edge=0, h_edge=0):
    """rgb HWC uint8, optional depth HW float, optional K [3,3].
    Returns (rgb_uint8 HWC at resolution, depth, K')."""
    if PIL is None:
        raise ModuleNotFoundError("crop_resize resamples with Pillow (PIL), which is "
                                  "not installed")
    image = PIL.Image.fromarray(rgb)
    W, H = image.size
    if K is None:
        cx, cy = int(W / 2), int(H / 2)
    else:
        cx, cy = K[:2, 2].round().astype(int)
    mx, my = min(cx, W - cx), min(cy, H - cy)
    assert mx > W / 5 and my > H / 5, "principal point too far off center"
    l = max(cx - mx, w_edge)
    t = max(cy - my, h_edge)
    r = min(cx + mx, W - w_edge)
    b = min(cy + my, H - h_edge)
    K_work = K.astype(np.float64).copy() if K is not None else np.array(
        [[1.0, 0, cx], [0, 1.0, cy], [0, 0, 1]])
    image, depth, K_work = _crop(image, depth, K_work, (l, t, r, b))

    res = tuple(resolution)
    W, H = image.size
    if H > 1.1 * W:  # portrait input
        res = res[::-1]
    image, depth, K_work = _rescale(image, depth, K_work, np.array(res))
    image, depth, K_work = _center_crop_to(image, depth, K_work, np.array(res))
    return np.asarray(image), depth, (K_work.astype(np.float32) if K is not None else None)


def to_model_inputs(rgb_uint8: np.ndarray) -> dict:
    """HWC uint8 -> {'rgb': float32 [-1,1] HWC, 'gray': uint8 HW}."""
    rgb = rgb_uint8.astype(np.float32) / 255.0
    gray = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2])
    return {
        "rgb": rgb * 2.0 - 1.0,
        "gray": np.clip(gray * 255.0, 0, 255).astype(np.uint8),
    }


def depth_to_points(depth: np.ndarray, K: np.ndarray):
    """Depth HW + K -> camera-frame points [H,W,3] and validity mask."""
    h, w = depth.shape
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    z = depth
    x = (xs - K[0, 2]) * z / K[0, 0]
    y = (ys - K[1, 2]) * z / K[1, 1]
    pts = np.stack([x, y, z], axis=-1)
    return pts, np.isfinite(z) & (z > 0)


def distance_to_points(dist: np.ndarray, K: np.ndarray):
    """Ray-distance HW (Euclidean range along the pixel ray, the Aria/ASE
    depth convention) + K -> camera-frame points [H,W,3] and validity mask
    (reference: vista_slam/utils/geometry.py:83-122,
    depthmap_to_camera_coordinates_ARIA)."""
    h, w = dist.shape
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    dx = (xs - K[0, 2]) / K[0, 0]
    dy = (ys - K[1, 2]) / K[1, 1]
    ray = np.stack([dx, dy, np.ones_like(dx)], axis=-1)
    ray /= np.linalg.norm(ray, axis=-1, keepdims=True)
    pts = ray * dist[..., None]
    return pts.astype(np.float32), np.isfinite(dist) & (dist > 0)
