"""The port's live, streaming and reproduction entry points without a camera
or released assets: LatestCamera on a written video, run_live.main against
the JAX package's on the same video and weights, the MJPEG server, and
reproduce.main on a synthetic TUM tree with a reference-layout .pth and a
vocabulary trained here (as tests/test_live_mode.py and
tests/test_reproduce_cli.py drive the JAX package's)."""

import importlib.abc
import json
import os
import socket
import subprocess
import sys
import textwrap
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(img_size=[64, 64], enc_dim=64, enc_depth=2, enc_heads=4, dec_dim=48,
             dec_depth=4, dec_heads=4, mlp_ratio=2)


@pytest.fixture(scope="module")
def video_file(tmp_path_factory):
    """A short video whose content shifts 8 px a frame (drives flow
    keyframing), as in tests/test_live_mode.py."""
    path = str(tmp_path_factory.mktemp("video") / "seq.avi")
    rng = np.random.default_rng(0)
    base = cv2.resize(rng.integers(0, 255, (60, 80, 3), np.uint8), (320, 240),
                      interpolation=cv2.INTER_CUBIC)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 20.0, (320, 240))
    assert w.isOpened()
    for i in range(40):
        w.write(cv2.warpAffine(base, np.float32([[1, 0, 8 * i], [0, 1, 0]]), (320, 240)))
    w.release()
    return path


def test_latest_camera_latest_wins(video_file):
    from vista_slam_tpu_torch.cli.run_live import LatestCamera

    cam = LatestCamera(video_file)
    try:
        deadline = time.time() + 5.0
        frame = None
        while frame is None and time.time() < deadline:
            frame = cam.read_latest()
            time.sleep(0.01)
        assert frame is not None and frame.shape == (240, 320, 3)
        # a frame once read is not returned again: None, or a newer frame
        again = cam.read_latest()
        assert again is None or not np.array_equal(again, frame)
    finally:
        cam.close()
    with pytest.raises(RuntimeError, match="cannot open"):
        LatestCamera(video_file + ".missing")


class SequentialCamera:
    """LatestCamera's interface over every frame of a file, in order and
    without a thread, so two runs see the same frames."""

    def __init__(self, source):
        self.cap = cv2.VideoCapture(source)

    def read_latest(self):
        ok, frame = self.cap.read()
        return frame if ok else None

    def close(self):
        self.cap.release()


def test_run_live_matches_jax(video_file, tmp_path, monkeypatch):
    """run_live.main of both packages on the same video (every frame read,
    in order) with the same weights (the port's seeded model, written by
    the port's save_params_npz and read by both): flow keyframing, SLAM
    steps, the state saved every 2 keyframes, the final PGO and the
    artifacts. The same keyframes and view graph; the trajectory within
    1e-3 as the last state file holds it (keyframe 6, before the final
    PGO; pgo_every is configs/live.yaml's 100, so no solve runs before).

    The final PGO (one solve in each run) is held three ways. Its losses
    before and after agree to 1e-5 relative. The trajectories after it
    agree within 2e-2: the solve (loss 400.3 -> 1.122) ends in a valley flat
    to the loss's fp32 resolution, mostly along the node scales, and the
    packages' 3.3e-5 pre-solve gap came out as 5.9e-3. And the port's
    solver, given the JAX run's own pre-solve graph, reaches the JAX solve's
    loss to 1e-5 and its nodes within 2e-2 (8.6e-3 measured), with the loss
    on the segment between the two solutions flat to 1e-5 relative (2e-7
    measured): the solvers agree on one input up to that valley."""
    import vista_slam_tpu.cli.run_live as jrun_live
    import vista_slam_tpu.slam.pgo as jpgo
    from vista_slam_tpu_torch.cli import run_live
    from vista_slam_tpu_torch.cli.common import build_frontend
    from vista_slam_tpu_torch.models.convert import save_params_npz
    from vista_slam_tpu_torch.ops import sim3
    from vista_slam_tpu_torch.slam import online_slam, pgo
    from vista_slam_tpu_torch.utils.config import make_config

    port_solve = online_slam.optimize_pose_graph
    solves = {"port": [], "jax": []}

    def record(name, solve):
        def wrapped(*args):
            new_nodes, info = solve(*args)
            solves[name].append(([np.asarray(a) for a in args[:6]], args[6],
                                 np.asarray(new_nodes), info))
            return new_nodes, info
        return wrapped

    monkeypatch.setattr(online_slam, "optimize_pose_graph",
                        record("port", online_slam.optimize_pose_graph))
    monkeypatch.setattr(jpgo, "optimize_pose_graph", record("jax", jpgo.optimize_pose_graph))
    weights = str(tmp_path / "w.npz")
    model = build_frontend(make_config(dict(device="cpu", compute_dtype="float32",
                                            model=MODEL))).model
    save_params_npz(weights, model)
    outs = {}
    for name, mod in (("port", run_live), ("jax", jrun_live)):
        monkeypatch.setattr(mod, "LatestCamera", SequentialCamera)
        outs[name] = str(tmp_path / name)
        cfg = tmp_path / f"{name}.yaml"
        cfg.write_text("\n".join([
            f"output_dir: {outs[name]}", "device: cpu", "compute_dtype: float32",
            f"sta_weights: {weights}", "max_view_num: 50", "neighbor_edge_num: 2",
            "loop_edge_num: 0", "pgo_every: 100", "state_every: 2", "rel_pose_thres: -1.0",
            "flow_thres: 2.0", "model:"]
            + [f"  {k}: {v}" for k, v in MODEL.items()]) + "\n")
        slam = mod.main(["--config", str(cfg), "--camera", video_file,
                         "--max-frames", "6", "--idle-timeout", "1"])
        if name == "port":
            assert slam.view_num == 6 and slam.flow_tracker.kf_gray is not None
    got, want = (np.load(os.path.join(outs[n], "slam_state.npz")) for n in ("port", "jax"))
    assert set(got.files) == set(want.files)
    for k in ("view_names", "node_view", "node_connected_view"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got["view_names"]) == 6
    g, w = got["node_poses"], want["node_poses"]
    assert np.isfinite(g).all() and np.isfinite(w).all()
    np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)
    vg = [np.load(os.path.join(outs[n], "view_graph.npz")) for n in ("port", "jax")]
    np.testing.assert_array_equal(vg[0]["edges"], vg[1]["edges"])

    assert len(solves["port"]) == len(solves["jax"]) == 1
    (_, port_cfg, _, port_info), (jax_graph, _, jax_nodes, jax_info) = (
        solves["port"][0], solves["jax"][0])
    for k in ("loss0", "loss"):
        assert np.isfinite(float(port_info[k])), k
        np.testing.assert_allclose(float(port_info[k]), float(jax_info[k]), rtol=1e-5,
                                   err_msg=k)
    trajs = [np.load(os.path.join(outs[n], "trajectory.npy")) for n in ("port", "jax")]
    assert trajs[0].shape == trajs[1].shape == (6, 4, 4)
    assert np.isfinite(trajs[0]).all() and np.isfinite(trajs[1]).all()
    np.testing.assert_allclose(trajs[0], trajs[1], atol=2e-2, rtol=0)

    nodes, edges, edge_poses, edge_confs, valid, opt = (torch.from_numpy(a) for a in jax_graph)
    new_nodes, info = port_solve(nodes, edges, edge_poses, edge_confs, valid, opt, port_cfg)
    assert torch.isfinite(new_nodes).all()
    np.testing.assert_allclose(info["loss"], float(jax_info["loss"]), rtol=1e-5)
    np.testing.assert_allclose(new_nodes.numpy(), jax_nodes, atol=2e-2, rtol=0)
    # the loss on the straight segment between the two solutions: flat
    edges = edges.long()
    keep = valid.bool() & (opt.bool()[edges[:, 0]] | opt.bool()[edges[:, 1]])
    losses = [pgo._loss(sim3.normalize(torch.lerp(torch.from_numpy(jax_nodes), new_nodes, t)),
                        edges[keep], edge_poses[keep], edge_confs[keep]).item()
              for t in np.linspace(0.0, 1.0, 6)]
    assert np.ptp(losses) <= 1e-5 * losses[0], losses


def test_mjpeg_stream_server(video_file):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    proc = subprocess.Popen(
        [sys.executable, "-m", "vista_slam_tpu_torch.cli.stream_camera",
         "--camera", video_file, "--port", str(port)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        data = b""
        deadline = time.time() + 15.0
        while time.time() < deadline:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/video",
                                            timeout=3) as r:
                    assert "multipart/x-mixed-replace" in r.headers.get("Content-Type", "")
                    data = r.read(40000)
                break
            except (ConnectionError, urllib.error.URLError, OSError):
                time.sleep(0.3)
        assert b"--frame" in data
        assert b"\xff\xd8" in data  # JPEG start-of-image marker
    finally:
        proc.kill()
        proc.wait()


def test_entry_points_name_opencv_when_missing(tmp_path):
    """With cv2 unimportable, LatestCamera, run_live.main and
    stream_camera.main raise a ModuleNotFoundError that names OpenCV."""
    from vista_slam_tpu_torch.cli import run_live, stream_camera

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] == "cv2":
                raise ModuleNotFoundError(name)

    saved = sys.modules.pop("cv2")
    sys.meta_path.insert(0, Block())
    try:
        for call in (lambda: run_live.LatestCamera("0"),
                     lambda: run_live.main(["--config", str(tmp_path / "none.yaml")]),
                     lambda: stream_camera.main(["--camera", "0"])):
            with pytest.raises(ModuleNotFoundError, match="OpenCV"):
                call()
    finally:
        sys.meta_path.pop(0)
        sys.modules["cv2"] = saved


def test_entry_modules_import_without_jax_yaml_pil_or_opencv():
    """The new entry points and utilities import in a fresh interpreter where
    jax, the JAX package, yaml, PIL and cv2 cannot be imported (as on the
    GPU machine); each needs OpenCV or PyYAML only where it starts work."""
    script = textwrap.dedent(f"""
        import importlib.abc, sys
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("yaml", "PIL", "cv2", "jax", "jaxlib",
                                          "vista_slam_tpu"):
                    raise ModuleNotFoundError(name)
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {REPO!r})
        import vista_slam_tpu_torch.cli.run_live, vista_slam_tpu_torch.cli.stream_camera
        import vista_slam_tpu_torch.cli.reproduce, vista_slam_tpu_torch.utils.profiling
        import vista_slam_tpu_torch.utils.consistency
        print("IMPORTS_OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "IMPORTS_OK" in proc.stdout


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """A reference-layout .pth (tests/torch_ref.py's TorchSTA), a vocabulary
    trained here in DBoW text, and a TUM-RGBD tree, as in
    tests/test_reproduce_cli.py."""
    from torch_ref import TorchSTA
    from vista_slam_tpu_torch.native.bow import train_vocabulary

    root = tmp_path_factory.mktemp("repro")
    torch.manual_seed(0)
    tm = TorchSTA(img=64, patch=16, ed=64, edep=2, eh=4, dd=48, ddep=4, dh=4)
    pth = str(root / "frontend_sta_weights.pth")
    torch.save({"model": tm.state_dict()}, pth)

    rng = np.random.default_rng(0)
    voc = train_vocabulary(rng.integers(0, 256, (400, 32), np.uint8), k=4, levels=3,
                           image_ids=np.repeat(np.arange(10), 40))
    vocab = str(root / "ORBvoc.txt")
    voc.save_dbow_text(vocab)

    scene = root / "data" / "rgbd_dataset_freiburg1_synth"
    os.makedirs(scene / "rgb")
    os.makedirs(scene / "depth")
    base = cv2.resize(rng.integers(0, 255, (60, 80, 3), np.uint8), (640, 480),
                      interpolation=cv2.INTER_CUBIC)
    lines = {"rgb.txt": [], "depth.txt": [], "groundtruth.txt": []}
    for i in range(8):
        ts = 1000.0 + i * 0.1
        cv2.imwrite(str(scene / "rgb" / f"{ts:.6f}.png"),
                    cv2.warpAffine(base, np.float32([[1, 0, 3 * i], [0, 1, 0]]), (640, 480)))
        cv2.imwrite(str(scene / "depth" / f"{ts:.6f}.png"),
                    np.full((480, 640), 10000 + 100 * i, np.uint16))
        lines["rgb.txt"].append(f"{ts:.6f} rgb/{ts:.6f}.png")
        lines["depth.txt"].append(f"{ts:.6f} depth/{ts:.6f}.png")
        lines["groundtruth.txt"].append(f"{ts:.6f} {0.1 * i:.4f} 0 0 0 0 0 1")
    for name, ls in lines.items():
        (scene / name).write_text("# header\n" + "\n".join(ls) + "\n")

    cfg = root / "base.yaml"
    cfg.write_text("\n".join([
        "device: cpu", "compute_dtype: float32", "stride: 1", "max_view_num: 10",
        "neighbor_edge_num: 2", "loop_edge_num: 1", "loop_dist_min: 2", "loop_nms: 1",
        "pgo_every: 500", "rel_pose_thres: -1.0", "model:"]
        + [f"  {k}: {v}" for k, v in MODEL.items()]) + "\n")
    return {"pth": pth, "vocab": vocab, "data_root": str(root / "data"), "cfg": str(cfg)}


def _reproduce(assets, out, extra):
    from vista_slam_tpu_torch.cli.reproduce import main

    return main(["--weights", assets["pth"], "--vocab", assets["vocab"],
                 "--dataset", "tumrgbd", "--data-root", assets["data_root"],
                 "--config", assets["cfg"], "--scenes", "synth", "--output", out, *extra])


def test_reproduce_end_to_end_and_tolerance_verdicts(assets, tmp_path, monkeypatch):
    """The .pth goes in as sta_torch_weights, loaded as it is (no .npz is
    written beside it), and runs the evaluation: the table without a
    verdict. The same weights as the JAX package's .npz (the port's
    convert_checkpoint_file; the port loads the same model from either
    file) go in as sta_weights. Their verdicts are read on that one
    evaluation's output: FAIL with exit code 1 against a reference 100x
    tighter than its ATE, PASS against its own ATE."""
    import yaml

    from vista_slam_tpu_torch.cli import evaluate
    from vista_slam_tpu_torch.cli.common import build_frontend
    from vista_slam_tpu_torch.models.convert import convert_checkpoint_file
    from vista_slam_tpu_torch.utils.config import make_config

    runs = []

    def keep(argv):
        runs.append(evaluate_main(argv))
        return runs[-1]

    evaluate_main = evaluate.main
    monkeypatch.setattr(evaluate, "main", keep)
    report = _reproduce(assets, str(tmp_path / "out1"), [])
    materialized = yaml.safe_load(open(tmp_path / "out1" / "reproduce_config.yaml"))
    assert materialized["sta_torch_weights"] == assets["pth"]
    assert materialized["sta_weights"] is None
    assert materialized["vocab_path"] == assets["vocab"]
    assert not any(f.endswith(".npz") for f in os.listdir(os.path.dirname(assets["pth"])))
    row = report["scenes"][0]
    assert row["scene"] == "synth" and np.isfinite(row["ate_rmse"]) and row["n_keyframes"] == 7
    assert "ok" not in row and report["failures"] == []
    saved = json.load(open(tmp_path / "out1" / "reproduce_report.json"))
    assert saved["scenes"][0]["ate_rmse"] == row["ate_rmse"]

    npz = str(tmp_path / "w.npz")
    convert_checkpoint_file(assets["pth"], npz)
    models = [build_frontend(make_config(dict(device="cpu", compute_dtype="float32",
                                              model=MODEL, **{key: path}))).model
              for key, path in (("sta_torch_weights", assets["pth"]), ("sta_weights", npz))]
    sd_pth, sd_npz = (m.state_dict() for m in models)
    assert sd_pth.keys() == sd_npz.keys()
    for k in sd_pth:
        torch.testing.assert_close(sd_npz[k], sd_pth[k], rtol=0, atol=0, msg=k)

    assert len(runs) == 1
    monkeypatch.setattr(evaluate, "main", lambda argv: runs[0])
    ref = tmp_path / "ref.json"
    ref.write_text(json.dumps({"synth": row["ate_rmse"] / 100.0}))
    with pytest.raises(SystemExit) as exc:
        _reproduce(dict(assets, pth=npz), str(tmp_path / "out2"),
                   ["--reference-ate", str(ref)])
    assert exc.value.code == 1
    materialized = yaml.safe_load(open(tmp_path / "out2" / "reproduce_config.yaml"))
    assert materialized["sta_weights"] == npz and materialized["sta_torch_weights"] is None
    failed = json.load(open(tmp_path / "out2" / "reproduce_report.json"))
    assert failed["failures"] == ["synth"] and not failed["scenes"][0]["ok"]
    assert failed["scenes"][0]["reference_ate"] == row["ate_rmse"] / 100.0

    ref.write_text(json.dumps({"synth": row["ate_rmse"]}))
    report3 = _reproduce(assets, str(tmp_path / "out3"), ["--reference-ate", str(ref)])
    assert report3["scenes"][0]["ok"] and report3["failures"] == []
    assert report3["scenes"][0]["rel_delta"] == 0.0
