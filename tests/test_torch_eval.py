"""The PyTorch port's evaluation path against the JAX package's:
eval/traj.py and eval/recon.py on the same inputs, the four sequence
loaders (TUM-RGBD, 7-Scenes, Replica, ScanNet) on trees the tests write
with OpenCV, and cli/evaluate.py end to end against the JAX package's on a
tiny TUM tree with the same weights."""

import json
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from test_eval import rand_poses
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)
from vista_slam_tpu.eval import recon as jrecon
from vista_slam_tpu.eval import traj as jtraj
from vista_slam_tpu_torch.eval import recon, traj


def _assert_same(got, want, path="result"):
    """Equal nested results: dicts, tuples, arrays and floats."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    else:
        assert np.isfinite(np.asarray(got, np.float64)).all(), path
        np.testing.assert_array_equal(got, want, err_msg=path)


def test_trajectory_eval_matches_jax(tmp_path):
    """Umeyama Sim(3) alignment and the APE statistics on a scaled,
    rotated, noisy copy of a trajectory with one non-finite reference pose;
    full_traj_eval with its plot directory."""
    rng = np.random.default_rng(0)
    ref = rand_poses(40, rng)
    est = ref.copy()
    est[:, :3, 3] = 0.5 * est[:, :3, 3] @ rand_poses(1, rng)[0, :3, :3].T + 0.3
    est[:, :3, 3] += 0.01 * rng.standard_normal((40, 3))
    ref[7, 0, 3] = np.nan
    _assert_same(traj.umeyama_alignment(est[:, :3, 3], np.nan_to_num(ref[:, :3, 3])),
                 jtraj.umeyama_alignment(est[:, :3, 3], np.nan_to_num(ref[:, :3, 3])))
    _assert_same(traj.ape_statistics(est, ref), jtraj.ape_statistics(est, ref))
    _assert_same(traj.ape_statistics(est, ref, align=False),
                 jtraj.ape_statistics(est, ref, align=False))
    _assert_same(traj.full_traj_eval(est, ref, str(tmp_path / "a")),
                 jtraj.full_traj_eval(est, ref, str(tmp_path / "b")))


def test_reconstruction_pieces_match_jax():
    """Voxel downsampling, point-to-point ICP and the clipped chamfer on
    seeded clouds."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (3000, 3))
    th = 0.05
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    moved = pts @ R.T + [0.02, -0.01, 0.03]
    _assert_same(recon.voxel_downsample(pts, 0.1), jrecon.voxel_downsample(pts, 0.1))
    _assert_same(recon.icp_point_to_point(moved, pts), jrecon.icp_point_to_point(moved, pts))
    outliers = moved + 0.6 * (rng.random((3000, 1)) > 0.9)
    _assert_same(recon.chamfer_rmse(pts, outliers), jrecon.chamfer_rmse(pts, outliers))


def test_recon_from_saved_data_matches_jax(tmp_path):
    """eval_recon_from_saved_data over an artifact directory written in the
    layout of OnlineSLAM.save_data_all, with and without a given alignment."""
    rng = np.random.default_rng(2)
    v, h, w = 5, 24, 32
    K = np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]], np.float32)
    gt = rand_poses(v, rng).astype(np.float32)
    gt_depth = (1.0 + rng.random((v, h, w))).astype(np.float32)
    scale = np.float32(0.5)
    arrays = {"depths.npy": gt_depth / scale + 0.01 * rng.standard_normal((v, h, w)),
              "scales.npy": np.full((v, 1), scale, np.float32),
              "trajectory.npy": gt, "intrinsics.npy": np.broadcast_to(K, (v, 3, 3)),
              "gt_depths.npy": gt_depth, "gt_poses.npy": gt, "gt_intrinsics.npy": K}
    for name, a in arrays.items():
        np.save(tmp_path / name, np.asarray(a, np.float32))
    np.savez(tmp_path / "confs.npz", confs=5 + rng.random((v, h, w)), thres=4.2)
    for rel in (None, [np.eye(3), np.zeros(3), 1.0]):
        got = recon.eval_recon_from_saved_data(str(tmp_path), rel)
        want = jrecon.eval_recon_from_saved_data(str(tmp_path), rel)
        _assert_same(got[:3], want[:3])
        _assert_same(got[3:], want[3:])


# ---------------------------------------------------------------------------
# the four loaders, on trees written with OpenCV

def _base(rng, h, w):
    return cv2.resize(rng.integers(0, 255, (h // 8, w // 8, 3), np.uint8), (w, h),
                      interpolation=cv2.INTER_CUBIC)


def _shift(img, dx):
    return cv2.warpAffine(img, np.float32([[1, 0, dx], [0, 1, 0]]),
                          (img.shape[1], img.shape[0]))


def write_tum(root, n=6):
    """A freiburg1-named TUM-RGBD scene: rgb/, depth/ (mm x 5), the three
    association lists and intrinsics.txt."""
    rng = np.random.default_rng(0)
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    base = _base(rng, 480, 640)
    lines = {"rgb.txt": [], "depth.txt": [], "groundtruth.txt": []}
    for i in range(n):
        ts = 1000.0 + i * 0.1
        cv2.imwrite(str(root / "rgb" / f"{ts:.6f}.png"), _shift(base, 3 * i))
        cv2.imwrite(str(root / "depth" / f"{ts:.6f}.png"),
                    np.full((480, 640), 10000 + 100 * i, np.uint16))
        lines["rgb.txt"].append(f"{ts:.6f} rgb/{ts:.6f}.png")
        lines["depth.txt"].append(f"{ts + 0.01:.6f} depth/{ts:.6f}.png")
        lines["groundtruth.txt"].append(f"{ts:.6f} {0.1 * i:.4f} 0 0 0 0 {0.05 * i:.4f} 1")
    for name, rows in lines.items():
        (root / name).write_text("# header\n" + "\n".join(rows) + "\n")
    (root / "intrinsics.txt").write_text("500 0 320\n0 500 240\n0 0 1\n")


def write_7scenes(d, n=4):
    rng = np.random.default_rng(1)
    os.makedirs(d)
    base = _base(rng, 480, 640)
    for i in range(n):
        stem = f"frame-{i:06d}"
        cv2.imwrite(str(d / f"{stem}.color.png"), _shift(base, 4 * i))
        depth = np.full((480, 640), 2000 + 10 * i, np.uint16)
        depth[:20] = 65535  # invalid Kinect depth
        cv2.imwrite(str(d / f"{stem}.depth.png"), depth)
        T = np.eye(4)
        T[:3, 3] = [0.05 * i, 0, 0]
        np.savetxt(d / f"{stem}.pose.txt", T)


def write_replica(d, n=4):
    rng = np.random.default_rng(2)
    os.makedirs(d / "results")
    base = _base(rng, 680, 1200)
    rows = []
    for i in range(n):
        cv2.imwrite(str(d / "results" / f"frame{i:06d}.jpg"), _shift(base, 6 * i))
        cv2.imwrite(str(d / "results" / f"depth{i:06d}.png"),
                    np.full((680, 1200), (2.0 + 0.1 * i) * 6553.5, np.uint16))
        T = np.eye(4)
        T[:3, 3] = [0.05 * i, 0, 0]
        rows.append(" ".join(map(str, T.reshape(-1))))
    (d / "traj.txt").write_text("\n".join(rows) + "\n")


def write_scannet(d, n=4):
    rng = np.random.default_rng(3)
    os.makedirs(d / "sensor_data")
    os.makedirs(d / "intrinsic")
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    np.savetxt(d / "intrinsic" / "intrinsic_depth.txt",
               np.block([[K, np.zeros((3, 1))], [np.zeros((1, 3)), np.ones((1, 1))]]))
    base = _base(rng, 968, 1296)  # color larger than depth, as in ScanNet
    for i in range(n):
        stem = f"frame-{i:06d}"
        cv2.imwrite(str(d / "sensor_data" / f"{stem}.color.jpg"), _shift(base, 5 * i))
        cv2.imwrite(str(d / "sensor_data" / f"{stem}.depth.png"),
                    np.full((480, 640), 1500 + 20 * i, np.uint16))
        T = np.eye(4)
        T[:3, 3] = [0.04 * i, 0, 0]
        np.savetxt(d / "sensor_data" / f"{stem}.pose.txt", T)


LOADERS = {  # class name, tree writer, scene directory, constructor keywords
    "tumrgbd": ("SLAMTUMRGBD", write_tum, "rgbd_dataset_freiburg1_synth",
                {"frame_rate": 1000}),
    "7scenes": ("SLAMSevenScenes", write_7scenes, "chess/seq-01", {}),
    "replica": ("SLAMReplica", write_replica, "office0", {}),
    "scannet": ("SLAMScanNet", write_scannet, "scene0000_00", {}),
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_sequence_loader_matches_jax(name, tmp_path):
    """Every item of the port's loader equals the JAX package's: rgb, gray,
    depth, intrinsics, pose, points and name."""
    from vista_slam_tpu import datasets as jdatasets
    from vista_slam_tpu_torch.datasets import slam_sequences

    cls, write, scene, kw = LOADERS[name]
    write(tmp_path / scene)
    got = getattr(slam_sequences, cls)(str(tmp_path / scene), resolution=(64, 80), **kw)
    want = getattr(jdatasets, cls)(str(tmp_path / scene), resolution=(64, 80), **kw)
    assert len(got) == len(want) >= 3
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w)
        assert g["img_name"] == w["img_name"]
        for k in w:
            if k != "img_name":
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name}[{i}].{k}")
        assert g["rgb"].shape[2] == 3 and (g["depth"] > 0).any()


def test_reproject_depth_to_rgb_matches_jax():
    from vista_slam_tpu.datasets.slam_sequences import _reproject_depth_to_rgb as jrepro
    from vista_slam_tpu_torch.datasets.slam_sequences import _reproject_depth_to_rgb

    rng = np.random.default_rng(4)
    K = np.array([[532.57, 0, 320], [0, 531.54, 240], [0, 0, 1]], np.float32)
    Kd = np.array([[598.84, 0, 320], [0, 587.62, 240], [0, 0, 1]], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.023449, 0.006177, 0.010525]
    depth = (1 + rng.random((480, 640))).astype(np.float32)
    np.testing.assert_array_equal(_reproject_depth_to_rgb(K, Kd, T, depth, 480, 640),
                                  jrepro(K, Kd, T, depth, 480, 640))


def test_loaders_name_opencv_when_missing(tmp_path, monkeypatch):
    from vista_slam_tpu_torch.datasets import slam_sequences

    write_7scenes(tmp_path / "s", n=1)
    monkeypatch.setattr(slam_sequences, "cv2", None)
    ds = slam_sequences.SLAMSevenScenes(str(tmp_path / "s"))
    with pytest.raises(ModuleNotFoundError, match="OpenCV"):
        ds[0]


# ---------------------------------------------------------------------------
# cli/evaluate.py end to end

MODEL = dict(img_size=[64, 64], enc_dim=64, enc_depth=1, enc_heads=1, dec_dim=64,
             dec_depth=2, dec_heads=1, mlp_ratio=2)


def test_evaluate_matches_jax_evaluate(tmp_path):
    """The port's evaluate main and the JAX package's evaluate_scene (the
    core of its main, with one compiled decode bucket) on one tiny TUM tree
    with the same weights (the port's seeded initialisation, converted to
    the JAX layout and saved as the .npz the port's config loads): the same keyframes and view graph, trajectories within 1e-3,
    ATE within 1e-3, reconstruction numbers finite and within 1%, and the
    same evaluation_results.json keys; the port also writes its summary."""
    import jax.numpy as jnp

    from vista_slam_tpu.cli.evaluate import evaluate_scene as jevaluate_scene
    from vista_slam_tpu.datasets import SLAMTUMRGBD as JTUM
    from vista_slam_tpu.models.convert import convert_state_dict, save_params_npz
    from vista_slam_tpu.models.sta import STAConfig as JSTAConfig
    from vista_slam_tpu.slam.frontend import FrontendEngine as JFrontend
    from vista_slam_tpu.slam.online_slam import OnlineSLAM as JSLAM
    from vista_slam_tpu.utils.config import load_config as jload_config
    from vista_slam_tpu_torch.cli.common import build_frontend
    from vista_slam_tpu_torch.cli.evaluate import main
    from vista_slam_tpu_torch.utils.config import make_config

    scene = tmp_path / "data" / "rgbd_dataset_freiburg1_synth"
    write_tum(scene, n=7)
    weights = str(tmp_path / "w.npz")
    jcfg = JSTAConfig(compute_dtype=jnp.float32, **dict(MODEL, img_size=(64, 64)))
    model = build_frontend(make_config(dict(device="cpu", compute_dtype="float32",
                                            model=MODEL))).model
    params = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    save_params_npz(weights, params)
    model = "\n".join(f"  {k}: {v}" for k, v in MODEL.items())
    cfg = tmp_path / "cfg.yaml"
    # point_conf_thres 0: every point counts (random weights give low
    # confidences)
    cfg.write_text(f"output_dir: {tmp_path / 'port'}\ndevice: cpu\ncompute_dtype: float32\n"
                   "stride: 1\nmax_view_num: 10\nneighbor_edge_num: 2\nloop_edge_num: 0\n"
                   "pgo_every: 500\nrel_pose_thres: -1.0\npoint_conf_thres: 0.0\n"
                   f"sta_weights: {weights}\nmodel:\n{model}\n")
    got = main(["--dataset", "tumrgbd", "--data-root", str(tmp_path / "data"),
                "--config", str(cfg), "--scenes", "synth", "--recon"])["synth"]
    out = tmp_path / "port" / "tumrgbd_synth"
    assert json.load(open(out / "evaluation_results.json")) == json.loads(json.dumps(got))
    assert (tmp_path / "port" / "tumrgbd_summary.json").exists()

    jslam = JSLAM(JFrontend(jcfg, params), max_view_num=10, neighbor_edge_num=2,
                  loop_edge_num=0, pgo_every=500, rel_pose_thres=-1.0, conf_thres=0.0)
    jslam.frontend.fixed_bucket = 2  # one compiled decode (padding is inert)
    jout = tmp_path / "jax"
    want = jevaluate_scene(jslam, JTUM(str(scene), resolution=(64, 64)),
                           jload_config(str(cfg)), str(jout), True)

    assert sorted(got) == sorted(want)
    assert got["n_keyframes"] == want["n_keyframes"] == 6
    vg = [np.load(d / "view_graph.npz") for d in (out, jout)]
    np.testing.assert_array_equal(vg[0]["edges"], vg[1]["edges"])
    trajs = [np.load(d / "trajectory.npy") for d in (out, jout)]
    assert np.isfinite(trajs[0]).all() and np.isfinite(trajs[1]).all()
    np.testing.assert_allclose(trajs[0], trajs[1], atol=1e-3)
    for k in ("ate_rmse", "ate_mean"):
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], atol=1e-3)
    for k in ("recon_acc", "recon_comp", "recon_chamfer"):
        assert np.isfinite(got[k]) and np.isfinite(want[k])
        np.testing.assert_allclose(got[k], want[k], rtol=1e-2)
    for name in ("gt_poses.npy", "gt_depths.npy", "gt_intrinsics.npy"):
        np.testing.assert_array_equal(np.load(out / name), np.load(jout / name))
