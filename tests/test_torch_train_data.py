"""The port's training data layer against the JAX package's, on the CPU.

Spec strings through both packages' ``build_dataset`` over a ScanNet tree
(tests/test_train_data.py::scannet_root), their ``TrainLoader`` batches with
0 and 2 reader threads, each of the seven view-graph readers on a tiny tree
of its format, the spec parser's refusals and the dataset algebra's lengths
and indices. Equality is exact: the port's readers are copies over the same
numpy and OpenCV calls.
"""

import json
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from test_train_data import scannet_root  # noqa: F401  (fixture reuse)
from vista_slam_tpu.datasets import combinators as jcomb
from vista_slam_tpu.datasets import view_graph as jvg
from vista_slam_tpu.train import data as jdata
from vista_slam_tpu_torch.datasets import combinators, view_graph
from vista_slam_tpu_torch.train import data
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def assert_same(a, b, path="item"):
    """Equal nested dicts / lists of numpy arrays, numbers and strings."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{k}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _spec(root, mult=4, per_scene=2, res=32, op="@"):
    data_root, vg_root = root
    return (f"{mult} {op} ScanNet(sensor_data_root='{data_root}', "
            f"view_graph_root='{vg_root}', resolution=({res}, {res}), "
            f"neighbor_range=4, neighbor_num=1, loop_num=1, "
            f"num_sample_per_scene={per_scene})")


@pytest.mark.parametrize("num_workers", [0, 2])
def test_build_dataset_and_loader_match_jax(scannet_root, num_workers):  # noqa: F811
    """The same spec in both packages: equal lengths, and epoch 1's
    collated batches array-equal, with the port reading on 0 or 2 threads
    (the JAX package's loader reads synchronously)."""
    spec = f"{_spec(scannet_root, mult=6)} + {_spec(scannet_root, mult=2, op='*')}"
    mine, theirs = data.build_dataset(spec), jdata.build_dataset(spec)
    assert len(mine) == len(theirs) == 6 + 2 * 4
    loaders = (data.TrainLoader(mine, 2, 3, num_workers=num_workers),
               jdata.TrainLoader(theirs, 2, 3))
    for loader in loaders:
        loader.set_epoch(1)
    assert len(loaders[0]) == len(loaders[1]) == 7
    n = 0
    for a, b in zip(*loaders):
        assert_same(a, b, f"batch {n}")
        n += 1
    assert n == 7


def test_sharded_loader_matches_jax(scannet_root):  # noqa: F811
    """world_size/rank: each process's batch-aligned shard is the JAX
    package's, and the two shards do not overlap."""
    spec = _spec(scannet_root, mult=8)
    seen = []
    for rank in (0, 1):
        mine = data.TrainLoader(data.build_dataset(spec), 2, 3, world_size=2, rank=rank)
        theirs = jdata.TrainLoader(jdata.build_dataset(spec), 2, 3, world_size=2, rank=rank)
        assert list(mine.sampler) == list(theirs.sampler)
        assert len(mine) == len(theirs) == 2
        seen.append({i for i, _ in mine.sampler})
    assert not seen[0] & seen[1]


@pytest.mark.parametrize("spec", [
    "ScanNet(sensor_data_root=__import__('os').getcwd())",
    "ScanNet('positional')",
    "ScanNet(view_graph_root=open('x').read())",
    "Evil(x=1)",
    "3 ^ ScanNet(x=1)",
])
def test_spec_parser_rejects_code_as_jax_does(spec):
    """Code, positional arguments, unknown names and other operators are
    refused by both parsers (the port always with a ValueError) before any
    dataset is built."""
    with pytest.raises(Exception):
        jdata.build_dataset(spec)
    with pytest.raises(ValueError):
        data.build_dataset(spec)


def test_spec_parser_splits_and_parses_as_jax_does():
    s = "2 @ A(x=(1, 2), y='a+b') + B(z=[3, {'k': 4}])"
    assert data._split_top_level(s, "+") == jdata._split_top_level(s, "+")
    assert data._parse_kwargs("x=(1, 2), y='a+b', z=None") == \
        jdata._parse_kwargs("x=(1, 2), y='a+b', z=None")
    assert set(data.REGISTRY) == set(jdata.REGISTRY)


class _Items:
    """A dataset whose item is its (index, resolution) pair."""

    def __init__(self, n, resolutions=1):
        self.n = n
        self._resolutions = [0] * resolutions
        self.epochs = []

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __getitem__(self, idx):
        return idx if isinstance(idx, tuple) else (idx, 0)


@pytest.mark.parametrize("epoch", [0, 3])
def test_dataset_algebra_matches_jax(epoch):
    """`+`, `N *` and `N @` (nested, re-drawn per epoch) give the JAX
    package's lengths and the same underlying indices."""
    def build(mod):
        class Items(_Items, mod.ComposableDataset):
            pass

        a, b, c = Items(5, 2), Items(3, 2), Items(7, 2)
        return 2 * a + 11 @ (b + 3 * c) + a

    mine, theirs = build(combinators), build(jcomb)
    assert type(mine).__name__ == type(theirs).__name__ == "CatDataset"
    for ds in (mine, theirs):
        ds.set_epoch(epoch)
    assert len(mine) == len(theirs) == 2 * 5 + 11 + 5
    assert mine.num_resolutions == theirs.num_resolutions == 2
    for i in range(len(mine)):
        for ar in (0, 1):
            assert mine[(i, ar)] == theirs[(i, ar)], (i, ar)
    s_mine = mine.make_sampler(4, world_size=2, rank=1)
    s_theirs = theirs.make_sampler(4, world_size=2, rank=1)
    for s in (s_mine, s_theirs):
        s.set_epoch(epoch)
    assert list(s_mine) == list(s_theirs)


def test_synthetic_scene_composes():
    from vista_slam_tpu_torch.datasets.synthetic_scene import SyntheticSceneDataset

    ds = SyntheticSceneDataset(n_frames=4, hw=(16, 16), focal=12.0)
    mixed = 2 * ds + 3 @ ds
    assert len(mixed) == 2 * 4 + 3 and mixed.num_resolutions == 1
    g = mixed[(5, 0)]  # the third item of 2 * ds: frame 2
    assert g["main_view"]["view_name"] == "synth_2"
    loader = data.TrainLoader(mixed, 2, 3)
    loader.set_epoch(0)
    assert next(iter(loader))["support_imgs"].shape == (3, 2, 16, 16, 3)


def test_readers_need_opencv_and_say_so(scannet_root, monkeypatch):  # noqa: F811
    """Without cv2 a reader raises an error naming it; it never hands back
    a stand-in view."""
    ds = data.build_dataset(_spec(scannet_root))
    monkeypatch.setattr(view_graph, "cv2", None)
    with pytest.raises(ModuleNotFoundError, match="cv2"):
        ds[0]


# --- one tiny tree per format, written as tests/test_data_formats.py does ---

H, W = 48, 64
K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]])
N = 6


def _rgb(rng, h=H, w=W):
    return rng.integers(0, 255, (h, w, 3), np.uint8)


def _mm(rng, h=H, w=W):
    return rng.integers(500, 3000, (h, w)).astype(np.uint16)


def _k44(k):
    return np.block([[k, np.zeros((3, 1))], [np.zeros((1, 3)), np.ones((1, 1))]])


def _viewgraph(vg, scene, names):
    os.makedirs(os.path.dirname(os.path.join(vg, scene)), exist_ok=True)
    with open(os.path.join(vg, f"{scene}_imglist.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    with open(os.path.join(vg, f"{scene}_viewgraph.txt"), "w") as f:
        for i in range(len(names)):
            f.write(f"{i}:({(i + len(names) // 2) % len(names)},0.5);\n")


def _pose(t):
    T = np.eye(4)
    T[:3, 3] = t
    return T


def _scannet(d, scene, rng):
    s = d / scene / "sensor_data"
    os.makedirs(s)
    os.makedirs(d / scene / "intrinsic")
    np.savetxt(d / scene / "intrinsic" / "intrinsic_depth.txt", _k44(K))
    for i in range(N):
        cv2.imwrite(str(s / f"frame-{i:06d}.color.jpg"), _rgb(rng))
        cv2.imwrite(str(s / f"frame-{i:06d}.depth.png"), _mm(rng))
        np.savetxt(s / f"frame-{i:06d}.pose.txt", _pose([0.1 * i, 0, 0]))
    return [f"frame-{i:06d}.color.jpg" for i in range(N)], {}


def _sevenscenes(d, scene, rng):
    os.makedirs(d / scene)
    for i in range(N):  # native Kinect frames: the fixed K assumes them
        cv2.imwrite(str(d / scene / f"frame-{i:06d}.color.png"), _rgb(rng, 480, 640))
        depth = _mm(rng, 480, 640)
        depth[0, :8] = 65535  # invalid marker
        cv2.imwrite(str(d / scene / f"frame-{i:06d}.depth.png"), depth)
        np.savetxt(d / scene / f"frame-{i:06d}.pose.txt", _pose([0.1 * i, 0, 0]))
    return [f"frame-{i:06d}.color.png" for i in range(N)], {}


def _scannetpp(d, scene, rng):
    dslr = d / scene / "dslr"
    for sub in ("undistorted_images", "undistorted_depths", "nerfstudio"):
        os.makedirs(dslr / sub)
    frames = []
    for i in range(N):
        cv2.imwrite(str(dslr / "undistorted_images" / f"DSC{i:05d}.JPG"), _rgb(rng))
        cv2.imwrite(str(dslr / "undistorted_depths" / f"DSC{i:05d}.png"), _mm(rng))
        frames.append({"file_path": f"DSC{i:05d}.JPG",
                       "transform_matrix": _pose([1.0, 2.0, 0.1 * i]).tolist()})
    with open(dslr / "nerfstudio" / "transforms_undistorted.json", "w") as f:
        json.dump({"fl_x": 40.0, "fl_y": 41.0, "cx": W / 2, "cy": H / 2,
                   "frames": frames}, f)
    return [f"DSC{i:05d}.JPG" for i in range(N)], {}


def _arkitscenes(d, scene, rng):
    for sub in ("lowres_wide", "lowres_depth", "lowres_wide_intrinsics"):
        os.makedirs(d / scene / sub)
    names, traj = [], []
    for i in range(N):
        ts = 300.0 + 0.377 * (i + 1)
        stem = f"{scene}_{ts:.3f}"
        cv2.imwrite(str(d / scene / "lowres_wide" / f"{stem}.png"), _rgb(rng))
        cv2.imwrite(str(d / scene / "lowres_depth" / f"{stem}.png"), _mm(rng))
        with open(d / scene / "lowres_wide_intrinsics" / f"{stem}.pincam", "w") as f:
            f.write(f"{W} {H} 40.0 40.0 {W / 2} {H / 2}\n")
        # one timestamp off the trajectory's by 0.02 s: the nearest-key fallback
        traj.append(f"{ts + (0.02 if i == 2 else 0):.6f} 0.1 0 0 {0.1 * i} 0 0")
        names.append(f"{stem}.png")
    with open(d / scene / "lowres_wide.traj", "w") as f:
        f.write("\n".join(traj) + "\n")
    return names, {}


def _replica(d, scene, rng):
    os.makedirs(d / scene)
    traj = []
    for i in range(N):
        cv2.imwrite(str(d / scene / f"frame{i:06d}.jpg"), _rgb(rng))
        depth = (rng.uniform(1.0, 4.0, (H, W)) * 6553.5).astype(np.uint16)
        cv2.imwrite(str(d / scene / f"depth{i:06d}.png"), depth)
        traj.append(" ".join(map(str, _pose([0, 0.1 * i, 0]).reshape(-1))))
    with open(d / scene / "camera.txt", "w") as f:
        f.write(f"# w,h,fx,fy\n{W},{H},40.0,40.0\n")
    with open(d / scene / "camera_trajectory.txt", "w") as f:
        f.write("\n".join(traj) + "\n")
    return [f"frame{i:06d}.jpg" for i in range(N)], {}


def _co3d(d, scene, rng):
    for sub in ("images", "depths", "masks"):
        os.makedirs(d / scene / sub)
    for i in range(N):
        stem = f"frame{i:06d}"
        cv2.imwrite(str(d / scene / "images" / f"{stem}.jpg"), _rgb(rng))
        cv2.imwrite(str(d / scene / "depths" / f"{stem}.jpg.geometric.png"),
                    rng.integers(10000, 60000, (H, W)).astype(np.uint16))
        mask = np.full((H, W), 255, np.uint8)
        mask[:, : W // 4] = 0
        cv2.imwrite(str(d / scene / "masks" / f"{stem}.png"), mask)
        np.savez(d / scene / "images" / f"{stem}.npz",
                 camera_pose=_pose([0.05 * i, 0, 0]).astype(np.float32),
                 camera_intrinsics=K.astype(np.float32), maximum_depth=np.float32(5.0))
    return [f"frame{i:06d}.jpg" for i in range(N)], {"mask_bg": True, "scene_name": scene}


def _aria(d, scene, rng):
    for sub in ("color", "depth", "pose", "intrinsic"):
        os.makedirs(d / scene / sub)
    np.savetxt(d / scene / "intrinsic" / "intrinsic_color.txt", _k44(K))
    for i in range(N):
        cv2.imwrite(str(d / scene / "color" / f"{i:07d}.jpg"), _rgb(rng))
        depth = _mm(rng)
        depth[0, :4] = 30000  # beyond the 20 m clamp
        cv2.imwrite(str(d / scene / "depth" / f"{i:07d}.png"), depth)
        np.savetxt(d / scene / "pose" / f"{i:07d}.txt", _pose([0, 0, 0.1 * i]))
    return [f"{i:07d}.jpg" for i in range(N)], {}


FORMATS = {"ScanNet": (_scannet, "scene0000_00"), "SevenScenes": (_sevenscenes, "chess"),
           "ScanNetpp": (_scannetpp, "0a5c013435"), "ARKitScenes": (_arkitscenes, "41069021"),
           "Replica": (_replica, "room_0"), "Co3d": (_co3d, "hydrant/194_20878"),
           "AriaSynthetic": (_aria, "ase_000001")}


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_reader_matches_jax(name, tmp_path):
    """Each reader on a tiny tree of its format: the same length and the
    same sampled view graphs (every view dict array-equal) as the JAX
    package's reader, at two indices and two epochs."""
    write, scene = FORMATS[name]
    names, extra = write(tmp_path / "data", scene, np.random.default_rng(len(name)))
    _viewgraph(str(tmp_path / "vg"), scene, names)
    kw = dict(sensor_data_root=str(tmp_path / "data"), view_graph_root=str(tmp_path / "vg"),
              resolution=(32, 32), neighbor_range=2, neighbor_num=1, loop_num=1,
              num_sample_per_scene=2, seed=0, **extra)
    mine, theirs = getattr(view_graph, name)(**kw), getattr(jvg, name)(**kw)
    assert len(mine) == len(theirs) == 2
    for epoch in (0, 1):
        mine.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for idx in (0, 1):
            got, want = mine[idx], theirs[idx]
            assert got["main_view"]["img"].shape == (32, 32, 3)
            assert np.isfinite(got["main_view"]["pts3d_cam"]).all()
            assert got["main_view"]["valid_mask"].any()
            assert_same(got, want, f"{name}[{idx}] epoch {epoch}")
