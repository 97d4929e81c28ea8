"""Training view-graph datasets: sample a main view + temporal neighbors +
loop views from precomputed view-graph files (a copy of
vista_slam_tpu/datasets/view_graph.py).

Capability-matched to the reference training datasets (reference:
vista_slam/datasets/scannet.py and siblings): per scene, a
``<scene>_imglist.txt`` lists frames in order and ``<scene>_viewgraph.txt``
lists loop candidates per frame as ``idx:(j,w);(k,w);...``. Sampling picks a
random center with enough margin, ``neighbor_num`` views on each side within
``neighbor_range``, and ``loop_num`` loop views (falling back to extra
neighbors), with bounded retries over unreadable frames.

The readers decode images with OpenCV. The module imports without it;
reading a view without it raises.

Each view dict (numpy):
  img [H,W,3] float32 in [-1,1], pts3d_cam [H,W,3], valid_mask [H,W],
  camera_pose [4,4], camera_intrinsics [3,3], true_shape (h, w)
"""

from __future__ import annotations

import glob
import os.path as osp

import numpy as np

from ..utils.optional import missing
from .combinators import ComposableDataset
from .preprocess import (crop_resize, depth_to_points, distance_to_points,
                         to_model_inputs)

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


class ViewGraphDataset(ComposableDataset):
    def __init__(self, *, sensor_data_root, view_graph_root, split=None,
                 resolution=(224, 224), neighbor_range=50, neighbor_num=1,
                 loop_num=1, num_sample_per_scene=10, sample_min_interval=1,
                 scene_name=None, seed=None, test_holdout=30):
        self.sensor_data_root = sensor_data_root
        self.view_graph_root = view_graph_root
        self.split = split
        self.neighbor_range = neighbor_range
        self.neighbor_num = neighbor_num
        self.loop_num = loop_num
        self.num_sample_per_scene = num_sample_per_scene
        self.sample_min_interval = sample_min_interval
        self._resolutions = ([resolution] if not isinstance(resolution[0], (list, tuple))
                             else [tuple(r) for r in resolution])
        self.seed = seed

        self.scene_names = sorted(
            osp.basename(p).rsplit("_imglist.txt", 1)[0]
            for p in glob.glob(osp.join(view_graph_root, "*imglist.txt")))
        if split == "train":
            self.scene_names = self.scene_names[:-test_holdout] or self.scene_names
        elif split == "test":
            self.scene_names = self.scene_names[-test_holdout:]
        if scene_name is not None:
            self.scene_names = ([scene_name] if isinstance(scene_name, str)
                                else list(scene_name))

    # -- per-format hooks -------------------------------------------------
    depth_is_distance = False  # Aria/ASE renders store ray range, not z
    max_depth: float | None = None  # format-specific far clamp (meters)
    crop_edge = 0  # border margin excluded before the crop (ScanNet: 10)

    def _scene_data_dir(self, scene_id: str) -> str:
        return osp.join(self.sensor_data_root, scene_id)

    def _scene_intrinsics(self, scene_id: str):
        return None

    def _read_view_raw(self, data_dir, view_name, scene_id):
        """Return (rgb uint8 HWC, depth float32 HW meters, pose 4x4, K 3x3)
        or None on failure."""
        raise NotImplementedError

    # -- shared machinery --------------------------------------------------
    def load_view_graph(self, scene_id):
        img_list_path = osp.join(self.view_graph_root, f"{scene_id}_imglist.txt")
        vg_path = osp.join(self.view_graph_root, f"{scene_id}_viewgraph.txt")
        with open(img_list_path) as f:
            img_list = [line.strip() for line in f if line.strip()]
        loops: dict[str, list[str]] = {}
        if osp.exists(vg_path):
            with open(vg_path) as f:
                for line in f:
                    if ":" not in line:
                        continue
                    key, value = line.strip().split(":", 1)
                    cands = []
                    for item in value.split(";"):
                        if item:
                            idx = item.strip("()").split(",")[0]
                            cands.append(img_list[int(idx)])
                    loops[img_list[int(key)]] = cands
        return img_list, loops

    def _read_view(self, data_dir, view_name, scene_id, resolution, rng):
        if cv2 is None:
            raise missing("cv2", "OpenCV", f"{type(self).__name__}'s image reading")
        raw = self._read_view_raw(data_dir, view_name, scene_id)
        if raw is None:
            return None
        rgb, depth, pose, K = raw
        if not (np.isfinite(pose).all() and np.isfinite(K).all()):
            return None
        depth = depth.copy()
        depth[~np.isfinite(depth)] = 0
        if self.max_depth is not None:
            depth[depth > self.max_depth] = 0
        if (depth > 0).sum() == 0:
            return None
        if rgb.shape[:2] != depth.shape:
            rgb = cv2.resize(rgb, (depth.shape[1], depth.shape[0]))
        rgb, depth, K2 = crop_resize(rgb, depth, K, resolution,
                                     w_edge=self.crop_edge, h_edge=self.crop_edge)
        unproject = distance_to_points if self.depth_is_distance else depth_to_points
        pts, valid = unproject(depth, K2)
        inputs = to_model_inputs(rgb)
        return {
            "img": inputs["rgb"],
            "pts3d_cam": np.nan_to_num(pts).astype(np.float32),
            "valid_mask": valid & (depth > 0),
            "camera_pose": pose.astype(np.float32),
            "camera_intrinsics": K2.astype(np.float32),
            "true_shape": np.asarray(rgb.shape[:2], np.int32),
            "view_name": view_name,
        }

    def frame_key(self, img_name: str) -> str:
        return img_name.split(".")[0]

    def sample_graph(self, scene_id, resolution, rng, attempt=0):
        """Sample {main_view, neighbor_views, loop_views} (reference:
        scannet.py:148-256)."""
        if attempt > 10:
            raise RuntimeError(f"failed to sample a view graph in {scene_id}")
        data_dir = self._scene_data_dir(scene_id)
        img_list, loops = self.load_view_graph(scene_id)
        nr = min(self.neighbor_range, max(len(img_list) // 3, 1))
        centers = list(range(nr, len(img_list) - nr, self.sample_min_interval))
        if not centers:
            raise RuntimeError(f"scene {scene_id} too short")

        center_view = None
        for _ in range(10):
            ci = int(rng.choice(centers))
            name = osp.basename(img_list[ci])
            if loops and name not in loops:
                continue
            center_view = self._read_view(data_dir, self.frame_key(name),
                                          scene_id, resolution, rng)
            if center_view is not None:
                break
        if center_view is None:
            return self.sample_graph(scene_id, resolution, rng, attempt + 1)

        def read_many(cands, count):
            out, used, failures = [], set(), 0
            while len(out) < count and failures <= 10 and len(used) < len(cands):
                j = int(rng.choice(len(cands)))
                if j in used:
                    continue
                used.add(j)
                v = self._read_view(data_dir, self.frame_key(osp.basename(cands[j])),
                                    scene_id, resolution, rng)
                if v is None:
                    failures += 1
                else:
                    out.append(v)
            return out, failures

        left = [img_list[k] for k in range(max(ci - nr, 0), ci)]
        right = [img_list[k] for k in range(ci + 1, min(ci + nr, len(img_list)))]
        lv, f1 = read_many(left, self.neighbor_num)
        rv, f2 = read_many(right, self.neighbor_num)
        loop_cands = loops.get(osp.basename(img_list[ci]), [])
        loop_views, f3 = read_many(loop_cands, self.loop_num)
        if len(loop_views) < self.loop_num:  # fall back to extra neighbors
            extra, _ = read_many(left + right, self.loop_num - len(loop_views))
            loop_views += extra
        if (len(lv) < self.neighbor_num or len(rv) < self.neighbor_num
                or len(loop_views) < self.loop_num):
            return self.sample_graph(scene_id, resolution, rng, attempt + 1)
        return {"main_view": center_view, "neighbor_views": lv + rv,
                "loop_views": loop_views}

    def __len__(self):
        return len(self.scene_names) * self.num_sample_per_scene

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)

    def __getitem__(self, idx):
        idx, ar = idx if isinstance(idx, tuple) else (idx, 0)
        resolution = self._resolutions[ar]
        scene_id = self.scene_names[idx // self.num_sample_per_scene]
        # per-(epoch, index) rng: sampling is deterministic AND safe under
        # concurrent loader workers (a shared Generator is neither)
        rng = np.random.default_rng(
            (self.seed if self.seed is not None else 1234,
             getattr(self, "_epoch", 0), int(idx), int(ar)))
        return self.sample_graph(scene_id, resolution, rng)


# ---------------------------------------------------------------------------
# concrete formats (reference: datasets/scannet.py, sevenscenes.py,
# scannetpp.py, arkitscene.py, replica.py, co3d.py, aria_synthetic.py)
# ---------------------------------------------------------------------------

def _imread(path, flags=None):
    img = cv2.imread(path) if flags is None else cv2.imread(path, flags)
    if img is None:
        return None
    if flags is None:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img


class ScanNet(ViewGraphDataset):
    """sensor_data/<frame>.color.jpg|.depth.png|.pose.txt +
    intrinsic/intrinsic_depth.txt (depth in mm)
    (reference: datasets/scannet.py:84-127)."""

    crop_edge = 10

    def _scene_data_dir(self, scene_id):
        return osp.join(self.sensor_data_root, scene_id, "sensor_data")

    def _read_view_raw(self, data_dir, view_name, scene_id):
        try:
            pose = np.loadtxt(osp.join(data_dir, f"{view_name}.pose.txt")).astype(np.float32)
            rgb = _imread(osp.join(data_dir, f"{view_name}.color.jpg"))
            depth = _imread(osp.join(data_dir, f"{view_name}.depth.png"),
                            cv2.IMREAD_UNCHANGED)
            K = np.loadtxt(osp.join(self.sensor_data_root, scene_id,
                                    "intrinsic", "intrinsic_depth.txt")
                           ).astype(np.float32)[:3, :3]
        except Exception:
            return None
        if rgb is None or depth is None:
            return None
        return rgb, depth.astype(np.float32) / 1000.0, pose, K


class SevenScenes(ViewGraphDataset):
    """<frame>.color.png|.depth.png|.pose.txt, nominal Kinect intrinsics
    (training uses fx=fy=525, reference: datasets/sevenscenes.py:237-238;
    the calibrated 532.57 values are the eval-time choice), mm depth with
    65535 as invalid."""

    K = np.asarray([[525.0, 0, 320], [0, 525.0, 240], [0, 0, 1]], np.float32)

    def _read_view_raw(self, data_dir, view_name, scene_id):
        try:
            pose = np.loadtxt(osp.join(data_dir, f"{view_name}.pose.txt")).astype(np.float32)
            rgb = _imread(osp.join(data_dir, f"{view_name}.color.png"))
            depth = _imread(osp.join(data_dir, f"{view_name}.depth.png"),
                            cv2.IMREAD_UNCHANGED)
        except Exception:
            return None
        if rgb is None or depth is None:
            return None
        depth = depth.astype(np.float32)
        depth[depth == 65535] = 0
        return rgb, depth / 1000.0, pose, self.K


class ScanNetpp(ViewGraphDataset):
    """dslr/undistorted_images/<f>.JPG + undistorted_depths/<f>.png (mm),
    poses/intrinsics from nerfstudio transforms json."""

    def _scene_data_dir(self, scene_id):
        return osp.join(self.sensor_data_root, scene_id, "dslr")

    def _load_meta(self, scene_id):
        import json

        cache = getattr(self, "_meta_cache", {})
        if scene_id not in cache:
            p = osp.join(self.sensor_data_root, scene_id,
                         "dslr/nerfstudio/transforms_undistorted.json")
            with open(p) as f:
                meta = json.load(f)
            frames = {osp.basename(fr["file_path"]).split(".")[0]: fr
                      for fr in meta["frames"]}
            K = np.asarray([[meta["fl_x"], 0, meta["cx"]],
                            [0, meta["fl_y"], meta["cy"]], [0, 0, 1]], np.float32)
            cache[scene_id] = (frames, K)
            self._meta_cache = cache
        return cache[scene_id]

    def _read_view_raw(self, data_dir, view_name, scene_id):
        try:
            frames, K = self._load_meta(scene_id)
            fr = frames[view_name]
            pose = np.asarray(fr["transform_matrix"], np.float32)
            # nerfstudio OpenGL camera + world axes -> OpenCV convention
            # (reference: datasets/scannetpp.py:86-90 — flip camera y/z
            # columns, then flip world y and z rows including translation)
            pose[:, 1:3] *= -1.0
            pose[2, :] *= -1.0
            pose[1, :] *= -1.0
            rgb = _imread(osp.join(data_dir, f"undistorted_images/{view_name}.JPG"))
            depth = _imread(osp.join(data_dir, f"undistorted_depths/{view_name}.png"),
                            cv2.IMREAD_UNCHANGED)
        except Exception:
            return None
        if rgb is None or depth is None:
            return None
        return rgb, depth.astype(np.float32) / 1000.0, pose, K


class ARKitScenes(ViewGraphDataset):
    """lowres_wide/<video>_<ts>.png + lowres_depth (mm) + per-frame .pincam
    intrinsics + lowres_wide.traj poses
    (reference: datasets/arkitscene.py:87-110,259-343)."""

    def frame_key(self, img_name: str) -> str:
        # timestamps contain '.', so strip only the .png suffix
        # (reference: arkitscene.py:173 splits on ".png")
        return img_name.split(".png")[0]

    def _load_traj(self, scene_id):
        cache = getattr(self, "_traj_cache", {})
        if scene_id not in cache:
            from scipy.spatial.transform import Rotation

            p = osp.join(self.sensor_data_root, scene_id, "lowres_wide.traj")
            poses = {}
            with open(p) as f:
                for line in f:
                    v = line.split()
                    if len(v) < 7:
                        continue
                    ts = f"{float(v[0]):.3f}"
                    T = np.eye(4, dtype=np.float32)
                    T[:3, :3] = Rotation.from_rotvec(np.asarray(v[1:4], float)).as_matrix()
                    T[:3, 3] = np.asarray(v[4:7], float)
                    poses[ts] = np.linalg.inv(T)  # world-to-cam -> cam-to-world
            cache[scene_id] = poses
            self._traj_cache = cache
        return cache[scene_id]

    def _read_view_raw(self, data_dir, view_name, scene_id):
        try:
            video_id, ts = view_name.rsplit("_", 1)
            poses = self._load_traj(scene_id)
            # exact timestamp key, else the LAST key within 0.1 s — the
            # reference scans the whole dict without breaking, so later
            # matches overwrite earlier ones (reference:
            # datasets/arkitscene.py:331-339)
            pose = poses.get(f"{float(ts):.3f}")
            if pose is None:
                for key, cand in poses.items():
                    if abs(float(ts) - float(key)) < 0.1:
                        pose = cand
            if pose is None:
                return None
            pin = osp.join(data_dir, "lowres_wide_intrinsics", f"{view_name}.pincam")
            if not osp.exists(pin):
                for delta in (-0.001, 0.001):
                    alt = osp.join(data_dir, "lowres_wide_intrinsics",
                                   f"{video_id}_{float(ts) + delta:.3f}.pincam")
                    if osp.exists(alt):
                        pin = alt
                        break
            _, _, fx, fy, hw, hh = np.loadtxt(pin)
            K = np.asarray([[fx, 0, hw], [0, fy, hh], [0, 0, 1]], np.float32)
            rgb = _imread(osp.join(data_dir, f"lowres_wide/{view_name}.png"))
            depth = _imread(osp.join(data_dir, f"lowres_depth/{view_name}.png"),
                            cv2.IMREAD_UNCHANGED)
        except Exception:
            return None
        if rgb is None or depth is None:
            return None
        return rgb, depth.astype(np.float32) / 1000.0, pose, K


class Replica(ViewGraphDataset):
    """Training Replica renders: frame*.jpg + depth*.png (scale 6553.5,
    >50 m invalid) directly in the scene dir, camera.txt intrinsics
    ("w,h,fx,fy" on line 2, principal point at the image center), flattened
    4x4 poses in camera_trajectory.txt
    (reference: datasets/replica.py:54-106)."""

    max_depth = 50.0

    def _load_camera(self, scene_id):
        cache = getattr(self, "_cam_cache", {})
        if scene_id not in cache:
            scene_path = osp.join(self.sensor_data_root, scene_id)
            with open(osp.join(scene_path, "camera.txt")) as f:
                lines = f.readlines()
            w, h, fx, fy = map(float, lines[1].strip().split(","))
            K = np.asarray([[fx, 0, (w - 1) / 2.0],
                            [0, fy, (h - 1) / 2.0], [0, 0, 1]], np.float32)
            with open(osp.join(scene_path, "camera_trajectory.txt")) as f:
                poses = [np.asarray(list(map(float, line.split())),
                                    np.float32).reshape(4, 4)
                         for line in f if line.strip()]
            cache[scene_id] = (K, poses)
            self._cam_cache = cache
        return cache[scene_id]

    def _read_view_raw(self, data_dir, view_name, scene_id):
        try:
            K, poses = self._load_camera(scene_id)
            idx = int("".join(c for c in view_name if c.isdigit()))
            pose = poses[idx]
            rgb = _imread(osp.join(data_dir, f"{view_name}.jpg"))
            depth = _imread(
                osp.join(data_dir, f"{view_name.replace('frame', 'depth')}.png"),
                cv2.IMREAD_UNCHANGED)
        except Exception:
            return None
        if rgb is None or depth is None:
            return None
        return rgb, depth.astype(np.float32) / 6553.5, pose, K


class Co3d(ViewGraphDataset):
    """images/<f>.jpg + depths/<f>.jpg.geometric.png (relative, scaled by the
    per-frame maximum_depth) + per-frame npz camera info; optional
    masks/<f>.png background masking
    (reference: datasets/co3d.py:63-92)."""

    def __init__(self, *, mask_bg=False, **kw):
        super().__init__(**kw)
        self.mask_bg = mask_bg

    def _read_view_raw(self, data_dir, view_name, scene_id):
        try:
            info = np.load(osp.join(data_dir, f"images/{view_name}.npz"))
            pose = info["camera_pose"].astype(np.float32)
            K = info["camera_intrinsics"].astype(np.float32)
            rgb = _imread(osp.join(data_dir, f"images/{view_name}.jpg"))
            depth = _imread(osp.join(data_dir, f"depths/{view_name}.jpg.geometric.png"),
                            cv2.IMREAD_UNCHANGED)
            depth = depth.astype(np.float32) / 65535.0 * np.nan_to_num(
                float(info["maximum_depth"]))
            if self.mask_bg:
                mask = _imread(osp.join(data_dir, f"masks/{view_name}.png"),
                               cv2.IMREAD_UNCHANGED)
                depth = depth * ((mask.astype(np.float32) / 255.0) > 0.1)
        except Exception:
            return None
        if rgb is None or depth is None:
            return None
        return rgb, depth, pose, K


class AriaSynthetic(ViewGraphDataset):
    """ASE-style renders: color/<f>.jpg + depth/<f>.png (mm, ray-distance
    convention, >20 m invalid) + pose/<f>.txt 4x4 poses +
    intrinsic/intrinsic_color.txt
    (reference: datasets/aria_synthetic.py:87-104,245-246; ray-distance
    unprojection per utils/geometry.py:83-122)."""

    depth_is_distance = True
    max_depth = 20.0

    def _read_view_raw(self, data_dir, view_name, scene_id):
        try:
            pose = np.loadtxt(osp.join(data_dir, "pose", f"{view_name}.txt")
                              ).astype(np.float32)
            if pose.shape != (4, 4):
                return None
            rgb = _imread(osp.join(data_dir, "color", f"{view_name}.jpg"))
            depth = _imread(osp.join(data_dir, "depth", f"{view_name}.png"),
                            cv2.IMREAD_UNCHANGED)
            K = np.loadtxt(osp.join(self.sensor_data_root, scene_id,
                                    "intrinsic", "intrinsic_color.txt")
                           ).astype(np.float32)[:3, :3]
        except Exception:
            return None
        if rgb is None or depth is None:
            return None
        return rgb, depth.astype(np.float32) / 1000.0, pose, K
