"""The port's result viewers (vista_slam_tpu_torch/scripts/vis_slam_results,
vis_ply, render_flythrough, extract_images, plot_train_log) on a result
directory that the port's OnlineSLAM.save_data_all writes and a log that
its Trainer writes: the checks of tests/test_vis_scripts.py, and the same
figures and video as the JAX package's scripts on the same files."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from test_torch_slam import frames
from vista_slam_tpu_torch.models.sta import STA, STAConfig
from vista_slam_tpu_torch.scripts import (extract_images, plot_train_log, render_flythrough,
                                          vis_ply, vis_slam_results)
from vista_slam_tpu_torch.slam.frontend import FrontendEngine
from vista_slam_tpu_torch.slam.online_slam import OnlineSLAM
from vista_slam_tpu_torch.train.trainer import Trainer
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

cv2 = pytest.importorskip("cv2")
pytest.importorskip("matplotlib")

JAX_SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "scripts")


def _jax_script(name):
    if JAX_SCRIPTS not in sys.path:
        sys.path.insert(0, JAX_SCRIPTS)
    return __import__(name)


@pytest.fixture(scope="module")
def result_dir(tmp_path_factory):
    """save_data_all of a 5-keyframe port run on a tiny random-weight model."""
    out = str(tmp_path_factory.mktemp("vis") / "results")
    cfg = STAConfig(img_size=(64, 64), patch_size=8, enc_dim=32, enc_depth=1, enc_heads=1,
                    dec_dim=32, dec_depth=2, dec_heads=1, mlp_ratio=2, head_type="linear",
                    compute_dtype=torch.float32)
    model = STA(cfg).init_weights_(torch.Generator().manual_seed(0))
    slam = OnlineSLAM(FrontendEngine(cfg, model), max_view_num=16, neighbor_edge_num=2,
                      loop_edge_num=0, pgo_every=500, rel_pose_thres=-1.0)
    seq = frames(5)
    for t, f in enumerate(seq):
        slam.step(f, force_pgo=(t == len(seq) - 1))
    slam.save_data_all(out)
    return out


def test_vis_slam_results(result_dir):
    vis_slam_results.main(["--result-dir", result_dir])
    assert os.path.getsize(os.path.join(result_dir, "vis_results.png")) > 0
    vg = np.load(os.path.join(result_dir, "view_graph.npz"), allow_pickle=True)
    assert len(vis_slam_results.view_graph_pairs(vg)) > 0


def test_vis_ply(result_dir):
    vis_ply.main(["--ply", os.path.join(result_dir, "pointcloud.ply"), "--views", "2"])
    assert os.path.getsize(os.path.join(result_dir, "pointcloud.png")) > 0


def test_render_flythrough_matches_jax(result_dir):
    """The port's video and the JAX script's, from the same files: the same
    bytes."""
    got, want = (os.path.join(result_dir, f"fly_{n}.mp4") for n in ("port", "jax"))
    argv = ["--result-dir", result_dir, "--interp", "2", "--size", "60", "80"]
    render_flythrough.main(argv + ["--out", got])
    _jax_script("render_flythrough").main(argv + ["--out", want])
    assert os.path.getsize(got) > 0
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


def test_extract_images_matches_jax(result_dir):
    """RGB, depth and confidence figures of views 0 and 3, byte for byte the
    JAX script's."""
    got, want = (os.path.join(result_dir, f"figures_{n}") for n in ("port", "jax"))
    extract_images.main(["--result-dir", result_dir, "--views", "0", "3", "--out", got])
    _jax_script("extract_images").main(["--result-dir", result_dir, "--views", "0", "3",
                                        "--out", want])
    names = sorted(os.listdir(got))
    assert names == sorted(os.listdir(want)) and len(names) == 6
    assert "view0003_depth.png" in names
    for n in names:
        np.testing.assert_array_equal(cv2.imread(os.path.join(got, n)),
                                      cv2.imread(os.path.join(want, n)), err_msg=n)


def test_plot_train_log(tmp_path):
    """A log.txt as the port's Trainer writes it (its _write_log)."""
    fake = types.SimpleNamespace(cfg=types.SimpleNamespace(output_dir=str(tmp_path)))
    for e in range(3):
        Trainer._write_log(fake, e, {"loss": 1.0 / (e + 1), "test_loss": 1.2 / (e + 1),
                                     "alpha": 0.2 * e})
    log = str(tmp_path / "log.txt")
    assert [json.loads(line)["epoch"] for line in open(log)] == [0, 1, 2]
    out = str(tmp_path / "curves.png")
    plot_train_log.main(["--log", log, "--out", out])
    assert os.path.getsize(out) > 0


def test_viewers_need_matplotlib_and_say_so(result_dir, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ModuleNotFoundError, match="matplotlib"):
        vis_ply.main(["--ply", os.path.join(result_dir, "pointcloud.ply")])
