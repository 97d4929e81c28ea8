"""The images-only sequence loader of the offline entry point (copy of
``SLAMImagesOnly`` in vista_slam_tpu/datasets/slam_sequences.py; reference:
vista_slam/datasets/slam_images_only.py). The evaluation loaders (TUM-RGBD,
7-Scenes, Replica, ScanNet) are not ported yet.

Each item is a dict of numpy arrays:
  rgb        HWC float32 in [-1, 1] (model input)
  gray       HW uint8 (flow tracker / ORB input)
  img_name   str
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from .preprocess import crop_resize, to_model_inputs

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def imread_rgb(path: str) -> np.ndarray:
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class SLAMImagesOnly:
    """Plain image glob for run-from-images mode (reference:
    datasets/slam_images_only.py)."""

    def __init__(self, image_paths, resolution=(224, 224)):
        self.resolution = resolution
        self.color_paths = sorted(image_paths)
        self.n_img = len(self.color_paths)

    def __len__(self):
        return self.n_img

    def __getitem__(self, i):
        rgb = imread_rgb(self.color_paths[i])
        rgb, _, _ = crop_resize(rgb, None, None, self.resolution, w_edge=10, h_edge=10)
        value = to_model_inputs(rgb)
        value["img_name"] = osp.basename(self.color_paths[i])
        return value
