"""The PyTorch port's SLAM state checkpoint (OnlineSLAM.save_state /
load_state, cli/run.py --resume-state): the cases of
tests/test_state_checkpoint.py on a tiny fp32 model, and the file against
the JAX package's for the same run with converted weights (the same npz
keys, dtypes and shapes; each package reads the other's file)."""

import glob
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from test_bow import make_textured_image
from test_torch_slam import MODEL, SLAM, frames, trajectory
from vista_slam_tpu_torch.cli.common import build_frontend
from vista_slam_tpu_torch.native import bow
from vista_slam_tpu_torch.slam.loop_detector import LoopDetector
from vista_slam_tpu_torch.slam.online_slam import OnlineSLAM
from vista_slam_tpu_torch.utils.config import make_config
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def frontend():
    return build_frontend(make_config(dict(SLAM, model=MODEL)))


def _descriptors(images):
    orb = cv2.ORB_create()
    descs, ids = [], []
    for i, img in enumerate(images):
        _, d = orb.detectAndCompute(img, None)
        if d is not None:
            descs.append(d)
            ids.append(np.full(len(d), i))
    return np.concatenate(descs), np.concatenate(ids)


def _slam(frontend, **kw):
    kw = dict(dict(max_view_num=8, neighbor_edge_num=1, loop_edge_num=0,
                   pgo_every=10 ** 6, rel_pose_thres=-1.0), **kw)
    return OnlineSLAM(frontend, **kw)


def _rgb(rng):
    return rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32)


def test_save_load_state_exact_resume(frontend, tmp_path):
    """A run checkpointed after 5 of 10 keyframes (one PGO before the
    checkpoint, a loop edge after it) and resumed in a fresh OnlineSLAM: the
    same view graph, edges, store arrays and trajectory as the
    uninterrupted run, and the same loop candidates from the restored BoW
    database."""
    n = 10
    grays = [make_textured_image(i) for i in range(n - 1)] + [make_textured_image(0)]
    rng = np.random.default_rng(0)
    rgbs = [_rgb(rng) for _ in range(n)]
    desc, ids = _descriptors(grays[: n - 1])
    vocab = bow.train_vocabulary(desc, k=6, levels=3, seed=0, image_ids=ids)

    def make_slam():
        det = LoopDetector(vocab, loop_dist_min=5, loop_nms=1, loop_cand_thresh_neighbor=3)
        return _slam(frontend, loop_detector=det, max_view_num=32, neighbor_edge_num=2,
                     loop_edge_num=2, pgo_every=500)

    def drive(slam, lo, hi):
        for t in range(lo, hi):
            slam.step({"rgb": rgbs[t], "gray": grays[t], "view_name": f"f{t}"},
                      force_pgo=(t in (4, n - 1)))

    uninterrupted = make_slam()
    drive(uninterrupted, 0, 5)
    path = str(tmp_path / "state.npz")
    uninterrupted.save_state(path, frame_cursor=4)  # saving changes nothing
    drive(uninterrupted, 5, n)

    resumed = make_slam()
    extras = resumed.load_state(path)
    assert int(extras["frame_cursor"]) == 4 and resumed.view_num == 5
    drive(resumed, 5, n)

    assert resumed.view_num == uninterrupted.view_num
    assert resumed.view_names == uninterrupted.view_names
    graph = resumed.get_view_graph()
    assert graph == uninterrupted.get_view_graph()
    assert any(abs(v - w) > 2 for v, ws in graph.items() for w in ws), "no loop edge"
    ga, gc = uninterrupted.graph, resumed.graph
    assert (ga.num_nodes, ga.num_edges) == (gc.num_nodes, gc.num_edges)
    np.testing.assert_array_equal(gc.edges[:gc.num_edges], ga.edges[:ga.num_edges])
    traj_a, traj_c = trajectory(uninterrupted), trajectory(resumed)
    assert np.isfinite(traj_c).all()
    np.testing.assert_allclose(traj_c, traj_a, atol=1e-6)
    for got, want in zip(resumed.pointmaps.fetch_many(range(gc.num_nodes)),
                         uninterrupted.pointmaps.fetch_many(range(ga.num_nodes))):
        np.testing.assert_array_equal(got, want)
    q = make_textured_image(1)
    assert resumed.lc_detector.detect(q, 3) == uninterrupted.lc_detector.detect(q, 3)


def test_cli_resume_from_checkpoint(tmp_path):
    """run.py --resume-state continues a state_every checkpoint to the same
    final trajectory, bit for bit, as an uninterrupted CLI run."""
    from vista_slam_tpu_torch.cli.run import main

    for k, f in enumerate(frames(6)):
        cv2.imwrite(str(tmp_path / f"frame_{k:03d}.png"),
                    cv2.cvtColor(((f["rgb"] + 1) * 127.5).astype(np.uint8), cv2.COLOR_RGB2BGR))
    images = str(tmp_path / "frame_*.png")
    model = "\n".join(f"  {k}: {v}" for k, v in MODEL.items())
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("\n".join(f"{k}: {v}" for k, v in SLAM.items())
                   + f"\nstate_every: 2\nmodel:\n{model}\n")
    out_a, out_b = str(tmp_path / "full"), str(tmp_path / "resumed")
    slam_a = main(["--config", str(cfg), "--images", images, "--output", out_a])
    state_path = os.path.join(out_a, "slam_state.npz")
    # written at keyframes 2 and 4: the last holds the cursor of frame 4
    assert int(np.load(state_path)["extra_frame_cursor"]) == 4
    slam_b = main(["--config", str(cfg), "--images", images, "--output", out_b,
                   "--resume-state", state_path])
    assert slam_b.view_num == slam_a.view_num == 5
    assert slam_b.view_names == slam_a.view_names
    traj_a = np.load(os.path.join(out_a, "trajectory.npy"))
    traj_b = np.load(os.path.join(out_b, "trajectory.npy"))
    assert np.isfinite(traj_b).all()
    np.testing.assert_allclose(traj_b, traj_a, atol=0.0)


def test_save_state_is_atomic(frontend, tmp_path):
    """Writes go through a temporary file and os.replace: an overwrite
    leaves no temporary file behind, and the file loads."""
    slam = _slam(frontend)
    rng = np.random.default_rng(5)
    for _ in range(3):
        slam.step({"rgb": _rgb(rng)})
    path = str(tmp_path / "state.npz")
    slam.save_state(path, frame_cursor=2)
    first = open(path, "rb").read()
    slam.save_state(path, frame_cursor=2)
    assert glob.glob(str(tmp_path / "*.tmp.npz")) == []
    fresh = _slam(frontend)
    assert int(fresh.load_state(path)["frame_cursor"]) == 2
    assert fresh.view_num == 3 and len(first) > 0


def test_save_state_before_any_decode(frontend, tmp_path):
    """A checkpoint after one keyframe (no store, empty graph) round-trips,
    and the run continues from its restored feature cache."""
    slam = _slam(frontend)
    rng = np.random.default_rng(6)
    slam.step({"rgb": _rgb(rng)})
    path = str(tmp_path / "early.npz")
    slam.save_state(path, frame_cursor=0)
    fresh = _slam(frontend)
    fresh.load_state(path)
    assert fresh.view_num == 1 and fresh.graph.num_nodes == 0 and fresh.pointmaps is None
    fresh.step({"rgb": _rgb(rng)})
    assert fresh.graph.num_edges > 0


def test_state_config_mismatch_raises(frontend, tmp_path):
    slam = _slam(frontend)
    slam.step({"rgb": _rgb(np.random.default_rng(7))})
    path = str(tmp_path / "state.npz")
    slam.save_state(path)
    with pytest.raises(ValueError, match="does not match"):
        _slam(frontend, neighbor_edge_num=2).load_state(path)


def test_state_file_matches_jax(frontend, tmp_path):
    """The same 4 keyframes through both packages' OnlineSLAM (converted
    weights, a loop detector, a flow-tracker keyframe): the two files hold
    the same keys with the same dtypes and shapes, and each package loads
    the other's file into the same graph and store."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vista_slam_tpu.models.convert import convert_state_dict
    from vista_slam_tpu.models.sta import STAConfig as JSTAConfig
    from vista_slam_tpu.native import bow as jbow
    from vista_slam_tpu.slam.frontend import FrontendEngine as JFrontend
    from vista_slam_tpu.slam.loop_detector import LoopDetector as JLoopDetector
    from vista_slam_tpu.slam.online_slam import OnlineSLAM as JSLAM

    seq = frames(4)
    grays = [make_textured_image(i) for i in range(4)]
    desc, ids = _descriptors(grays)
    kw = dict(max_view_num=8, neighbor_edge_num=2, loop_edge_num=2, pgo_every=10 ** 6,
              rel_pose_thres=-1.0)
    det = dict(loop_dist_min=5, loop_nms=1, loop_cand_thresh_neighbor=3)

    def drive(slam):
        for t, f in enumerate(seq):
            slam.step({"rgb": f["rgb"], "gray": grays[t], "view_name": f["img_name"]})
        slam.flow_tracker.is_new_keyframe(grays[-1])

    slam = OnlineSLAM(frontend, loop_detector=LoopDetector(
        bow.train_vocabulary(desc, k=6, levels=3, seed=0, image_ids=ids), **det), **kw)
    drive(slam)
    path = str(tmp_path / "port.npz")
    slam.save_state(path, frame_cursor=3)

    sd = {k: v.numpy() for k, v in frontend.model.state_dict().items()}
    jcfg = JSTAConfig(compute_dtype=jnp.float32, **dict(MODEL, img_size=tuple(MODEL["img_size"])))
    jdet = JLoopDetector(jbow.train_vocabulary(desc, k=6, levels=3, seed=0, image_ids=ids), **det)
    with pltpu.force_tpu_interpret_mode():
        jslam = JSLAM(JFrontend(jcfg, convert_state_dict(sd)), loop_detector=jdet, **kw)
        jslam.frontend.fixed_bucket = 2  # one compiled decode (padding is inert)
        drive(jslam)
        jpath = str(tmp_path / "jax.npz")
        jslam.save_state(jpath, frame_cursor=3)

        got, want = np.load(path), np.load(jpath)
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert (got[k].dtype, got[k].shape) == (want[k].dtype, want[k].shape), k
        for k in ("view_num", "num_nodes", "num_edges", "node_view", "edges",
                  "best_views", "best_nodes", "view_names", "bow_present", "bow_ids",
                  "flow_kf_gray", "extra_frame_cursor"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

        port_from_jax = OnlineSLAM(frontend, **kw)
        port_from_jax.load_state(jpath)
        jax_from_port = JSLAM(jslam.frontend, **kw)
        jax_from_port.load_state(path)
    assert port_from_jax.get_view_graph() == jslam.get_view_graph()
    assert jax_from_port.get_view_graph() == slam.get_view_graph()
    n = slam.graph.num_nodes
    for a, b in zip(port_from_jax.pointmaps.fetch_many(range(n)),
                    jslam.pointmaps.fetch_many(range(n))):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(torch.cat(port_from_jax.enc_feats).numpy(),
                                  np.asarray(want["enc_feats"]))
