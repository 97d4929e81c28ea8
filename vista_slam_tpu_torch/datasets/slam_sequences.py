"""Sequence loaders of the entry points: images-only, TUM-RGBD, 7-Scenes,
Replica and ScanNet (copies of vista_slam_tpu/datasets/slam_sequences.py;
reference: vista_slam/datasets/slam_*.py). Images are read with OpenCV,
imported when the module is; without it a loader raises an error that names
the package when it first reads an image.

Each item is a dict of numpy arrays:
  rgb        HWC float32 in [-1, 1] (model input)
  gray       HW uint8 (flow tracker / ORB input)
  depth      HW float32 meters (GT, eval datasets only)
  intrinsic  [3, 3] (post-crop, eval datasets only)
  camera_pose [4, 4] cam-to-world (GT, eval datasets only)
  pts3d_cam  [H, W, 3] GT points in camera frame (eval datasets only)
  img_name   str
"""

from __future__ import annotations

import glob
import os.path as osp

import numpy as np

from ..utils.optional import missing
from .preprocess import crop_resize, depth_to_points, to_model_inputs

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _need_cv2():
    if cv2 is None:
        raise missing("cv2", "OpenCV", "the sequence loaders' image reading")


def imread_rgb(path: str) -> np.ndarray:
    _need_cv2()
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def imread_raw(path: str) -> np.ndarray:
    _need_cv2()
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    return img


class _Sequence:
    resolution = (224, 224)

    def __len__(self):
        return self.n_img

    def _pack(self, rgb_uint8, name, depth=None, K=None, pose=None):
        value = to_model_inputs(rgb_uint8)
        value["img_name"] = name
        if depth is not None:
            value["depth"] = depth
            value["intrinsic"] = K
            value["camera_pose"] = pose
            pts, _ = depth_to_points(depth, K)
            value["pts3d_cam"] = pts
        return value


class SLAMImagesOnly(_Sequence):
    """Plain image glob for run-from-images mode (reference:
    datasets/slam_images_only.py)."""

    def __init__(self, image_paths, resolution=(224, 224)):
        self.resolution = resolution
        self.color_paths = sorted(image_paths)
        self.n_img = len(self.color_paths)

    def __getitem__(self, i):
        rgb = imread_rgb(self.color_paths[i])
        rgb, _, _ = crop_resize(rgb, None, None, self.resolution, w_edge=10, h_edge=10)
        return self._pack(rgb, osp.basename(self.color_paths[i]))


class SLAMTUMRGBD(_Sequence):
    """TUM-RGBD with timestamp association of rgb/depth/groundtruth and
    frame-rate subsampling (reference: datasets/slam_tumrgbd.py)."""

    INTRINSICS = {
        "freiburg1": [[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]],
        "freiburg2": [[520.9, 0, 325.1], [0, 521.0, 249.7], [0, 0, 1]],
        "freiburg3": [[535.4, 0, 320.1], [0, 539.2, 247.6], [0, 0, 1]],
    }

    def __init__(self, path_to_scene, resolution=(224, 224), frame_rate=32):
        self.resolution = resolution
        self.input_folder = path_to_scene
        self.color_paths, self.depth_paths, self.poses = self._load(
            path_to_scene, frame_rate)
        self.n_img = len(self.color_paths)
        intri_file = osp.join(path_to_scene, "intrinsics.txt")
        if osp.exists(intri_file):
            self.intri = np.loadtxt(intri_file).astype(np.float32)
        else:
            for tag, K in self.INTRINSICS.items():
                if tag in path_to_scene:
                    self.intri = np.asarray(K, np.float32)
                    break
            else:
                raise ValueError(f"cannot infer intrinsics for {path_to_scene}")

    @staticmethod
    def _parse_list(path):
        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                rows.append(line.split())
        return rows

    def _load(self, datapath, frame_rate):
        from scipy.spatial.transform import Rotation

        pose_file = osp.join(datapath, "groundtruth.txt")
        if not osp.isfile(pose_file):
            pose_file = osp.join(datapath, "pose.txt")
        images = self._parse_list(osp.join(datapath, "rgb.txt"))
        depths = self._parse_list(osp.join(datapath, "depth.txt"))
        poses = self._parse_list(pose_file)
        t_img = np.asarray([r[0] for r in images], np.float64)
        t_dep = np.asarray([r[0] for r in depths], np.float64)
        t_pos = np.asarray([r[0] for r in poses], np.float64)
        pose_vecs = np.asarray([r[1:] for r in poses], np.float64)

        assoc = []
        for i, t in enumerate(t_img):
            j = int(np.argmin(np.abs(t_dep - t)))
            k = int(np.argmin(np.abs(t_pos - t)))
            if abs(t_dep[j] - t) < 0.08 and abs(t_pos[k] - t) < 0.08:
                assoc.append((i, j, k))

        keep = [0]
        for n in range(1, len(assoc)):
            if t_img[assoc[n][0]] - t_img[assoc[keep[-1]][0]] > 1.0 / frame_rate:
                keep.append(n)

        color, depth, pose_mats = [], [], []
        inv_first = None
        for n in keep:
            i, j, k = assoc[n]
            color.append(osp.join(datapath, images[i][1]))
            depth.append(osp.join(datapath, depths[j][1]))
            T = np.eye(4)
            T[:3, :3] = Rotation.from_quat(pose_vecs[k][3:7]).as_matrix()
            T[:3, 3] = pose_vecs[k][:3]
            if inv_first is None:
                inv_first = np.linalg.inv(T)
                T = np.eye(4)
            else:
                T = inv_first @ T
            pose_mats.append(T)
        return color, depth, pose_mats

    def __getitem__(self, i):
        pose = self.poses[i].astype(np.float32)
        rgb = imread_rgb(self.color_paths[i])
        depth = imread_raw(self.depth_paths[i]).astype(np.float32) / 5000.0
        depth[~np.isfinite(depth)] = 0
        rgb = cv2.resize(rgb, (depth.shape[1], depth.shape[0]))
        rgb, depth, K = crop_resize(rgb, depth, self.intri, self.resolution,
                                    w_edge=10, h_edge=10)
        return self._pack(rgb, osp.basename(self.color_paths[i]), depth, K, pose)


def _reproject_depth_to_rgb(K_rgb, K_depth, T_rgb_to_depth, depth_img, h_rgb, w_rgb):
    """Project a depth image into the RGB camera frame (reference:
    datasets/slam_sevenscenes.py:15-86)."""
    K_rgb_inv = np.linalg.inv(K_rgb)
    R = T_rgb_to_depth[:3, :3]
    t = T_rgb_to_depth[:3, 3:]
    h_d, w_d = depth_img.shape
    u, v = np.meshgrid(np.arange(w_rgb), np.arange(h_rgb))
    pix = np.stack([u, v, np.ones_like(u)], -1).reshape(-1, 3).T
    rays_rgb = K_rgb_inv @ pix
    rays_depth = R @ rays_rgb
    proj = K_depth @ (rays_depth + t)
    u_d = np.round(proj[0] / proj[2]).astype(np.int32)
    v_d = np.round(proj[1] / proj[2]).astype(np.int32)
    valid = (u_d >= 0) & (u_d < w_d) & (v_d >= 0) & (v_d < h_d) & (rays_depth[2] != 0)
    d = np.zeros(rays_rgb.shape[1], np.float32)
    d[valid] = depth_img[v_d[valid], u_d[valid]]
    lam = np.zeros_like(d)
    lam[valid] = (d[valid] - t[2, 0]) / rays_depth[2, valid]
    depth_rgb = (rays_rgb * lam[None]).reshape(3, h_rgb, w_rgb)[2]
    depth_rgb[~valid.reshape(h_rgb, w_rgb)] = np.nan
    return depth_rgb


class SLAMSevenScenes(_Sequence):
    """7-Scenes: Kinect depth reprojected into the RGB frame with the fixed
    RGB<->depth extrinsics (reference: datasets/slam_sevenscenes.py:89-160)."""

    def __init__(self, path_to_scene, resolution=(224, 224)):
        self.resolution = resolution
        self.color_paths = sorted(glob.glob(osp.join(path_to_scene, "*.color.png")))
        self.depth_paths = sorted(glob.glob(osp.join(path_to_scene, "*.depth.png")))
        self.pose_paths = sorted(glob.glob(osp.join(path_to_scene, "*.pose.txt")))
        self.n_img = len(self.color_paths)
        fx, fy, cx, cy = 532.57, 531.54, 320, 240
        fx_d, fy_d = 598.84, 587.62
        self.intri = np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        self.intri_depth = np.asarray([[fx_d, 0, cx], [0, fy_d, cy], [0, 0, 1]], np.float32)
        self.T_rgb_d = np.asarray(
            [[1, 0, 0, 0.023449], [0, 1, 0, 0.006177],
             [0, 0, 1, 0.010525], [0, 0, 0, 1]], np.float32)

    def __getitem__(self, i):
        pose = np.loadtxt(self.pose_paths[i]).astype(np.float32)
        rgb = imread_rgb(self.color_paths[i])
        depth = imread_raw(self.depth_paths[i]).astype(np.float32)
        depth[depth == 65535] = 0
        depth /= 1000.0
        depth = _reproject_depth_to_rgb(self.intri, self.intri_depth, self.T_rgb_d,
                                        depth, rgb.shape[0], rgb.shape[1])
        depth[~np.isfinite(depth)] = 0
        rgb, depth, K = crop_resize(rgb, depth, self.intri, self.resolution,
                                    w_edge=10, h_edge=10)
        return self._pack(rgb, osp.basename(self.color_paths[i]), depth, K, pose)


class SLAMReplica(_Sequence):
    """Replica renders: results/frame*.jpg + depth*.png, traj.txt poses
    (reference: datasets/slam_replica.py)."""

    def __init__(self, path_to_scene, resolution=(224, 224)):
        self.resolution = resolution
        folder = osp.join(path_to_scene, "results")
        self.color_paths = sorted(glob.glob(osp.join(folder, "frame*.jpg")))
        self.depth_paths = sorted(glob.glob(osp.join(folder, "depth*.png")))
        self.n_img = len(self.color_paths)
        with open(osp.join(path_to_scene, "traj.txt")) as f:
            lines = f.readlines()
        self.poses = [np.asarray(list(map(float, lines[i].split()))).reshape(4, 4)
                      for i in range(self.n_img)]
        self.intri = np.asarray([[600.0, 0, 599.5], [0, 600.0, 339.5], [0, 0, 1]],
                                np.float32)

    def __getitem__(self, i):
        pose = self.poses[i].astype(np.float32)
        rgb = imread_rgb(self.color_paths[i])
        depth = imread_raw(self.depth_paths[i]).astype(np.float32) / 6553.5
        depth[~np.isfinite(depth)] = 0
        rgb = cv2.resize(rgb, (depth.shape[1], depth.shape[0]))
        rgb, depth, K = crop_resize(rgb, depth, self.intri, self.resolution,
                                    w_edge=0, h_edge=0)
        return self._pack(rgb, osp.basename(self.color_paths[i]), depth, K, pose)


class SLAMScanNet(_Sequence):
    """ScanNet sensor dumps: sensor_data/*.color.jpg|*.depth.png|*.pose.txt +
    intrinsic/intrinsic_depth.txt (reference: datasets/slam_scannet.py)."""

    def __init__(self, path_to_scene, resolution=(224, 224)):
        self.resolution = resolution
        folder = osp.join(path_to_scene, "sensor_data")
        self.color_paths = sorted(glob.glob(osp.join(folder, "*.color.jpg")))
        self.depth_paths = sorted(glob.glob(osp.join(folder, "*.depth.png")))
        self.pose_paths = sorted(glob.glob(osp.join(folder, "*.pose.txt")))
        self.n_img = len(self.color_paths)
        self.intri = np.loadtxt(
            osp.join(path_to_scene, "intrinsic", "intrinsic_depth.txt")
        ).astype(np.float32)[:3, :3]

    def __getitem__(self, i):
        pose = np.loadtxt(self.pose_paths[i]).astype(np.float32)
        rgb = imread_rgb(self.color_paths[i])
        depth = imread_raw(self.depth_paths[i]).astype(np.float32) / 1000.0
        depth[~np.isfinite(depth)] = 0
        rgb = cv2.resize(rgb, (depth.shape[1], depth.shape[0]))
        rgb, depth, K = crop_resize(rgb, depth, self.intri, self.resolution,
                                    w_edge=10, h_edge=10)
        return self._pack(rgb, osp.basename(self.color_paths[i]), depth, K, pose)
