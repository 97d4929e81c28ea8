"""The PyTorch port's SLAM slice against the JAX package's, end to end on
the CPU, plus the port's dependency rules and its chip smoke script."""

import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from vista_slam_tpu_torch.datasets.synthetic_scene import BoxScene, orbit_trajectory
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(img_size=[64, 64], enc_dim=64, enc_depth=1, enc_heads=1, dec_dim=64,
             dec_depth=2, dec_heads=1, mlp_ratio=2, use_flash=True)
SLAM = dict(compute_dtype="float32", keyframe_detection="stride", stride=1,
            max_view_num=10, neighbor_edge_num=2, loop_edge_num=2,
            rel_pose_thres=-1.0, device="cpu")


def frames(n=6, hw=(64, 64)):
    K = np.array([[48.0, 0, hw[1] / 2], [0, 48.0, hw[0] / 2], [0, 0, 1]])
    out = []
    for k, pose in enumerate(orbit_trajectory(n, radius=1.0)):
        rgb, _ = BoxScene().render(pose, K, hw)
        out.append({"rgb": (rgb * 2 - 1).astype(np.float32),
                    "gray": (rgb.mean(-1) * 255).astype(np.uint8), "img_name": f"f{k}"})
    return out


def trajectory(slam):
    return np.stack([slam.graph.view_pose_scale(v)[0] for v in range(slam.view_num)])


def test_run_sequence_matches_jax():
    """Same 6 frames, same weights: same keyframes and view graph, and
    trajectories within 1e-3 after the final PGO."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vista_slam_tpu.cli.run import run_sequence as jax_run_sequence
    from vista_slam_tpu.models.convert import convert_state_dict
    from vista_slam_tpu.models.sta import STAConfig as JSTAConfig
    from vista_slam_tpu.slam.frontend import FrontendEngine as JFrontend
    from vista_slam_tpu.slam.online_slam import OnlineSLAM as JSLAM
    from vista_slam_tpu_torch.cli.common import build_slam
    from vista_slam_tpu_torch.cli.run import run_sequence
    from vista_slam_tpu_torch.utils.config import make_config

    cfg = make_config(dict(SLAM, model=MODEL))
    seq = frames()
    slam = build_slam(cfg)
    run_sequence(slam, seq, cfg)

    sd = {k: v.numpy() for k, v in slam.frontend.model.state_dict().items()}
    jcfg = JSTAConfig(compute_dtype=jnp.float32,
                      **dict(MODEL, img_size=tuple(MODEL["img_size"])))
    with pltpu.force_tpu_interpret_mode():
        jslam = JSLAM(JFrontend(jcfg, convert_state_dict(sd)), max_view_num=10,
                      neighbor_edge_num=2, loop_edge_num=2, rel_pose_thres=-1.0)
        jslam.frontend.fixed_bucket = 2  # one compiled decode (padding is inert)
        jax_run_sequence(jslam, seq, cfg)

    assert slam.view_num == jslam.view_num == len(seq) - 1
    assert slam.get_view_graph() == jslam.get_view_graph()
    # one device->host copy per keyframe with an edge batch
    assert slam.frontend.fetch_count == jslam.frontend.fetch_count == len(seq) - 2
    got, want = trajectory(slam), trajectory(jslam)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_pointmap_store_matches_jax():
    from vista_slam_tpu.slam.pointmap_store import DevicePointmapStore as JStore
    from vista_slam_tpu_torch.slam.pointmap_store import DevicePointmapStore

    rng = np.random.default_rng(7)
    depth = rng.uniform(0.5, 3.0, (4, 6, 8)).astype(np.float32)
    conf = rng.uniform(1.0, 5.0, (4, 6, 8)).astype(np.float32)
    intri = rng.standard_normal((4, 3, 3)).astype(np.float32)
    idx = [3, 0, 7, 5]
    store, jstore = DevicePointmapStore(9, (6, 8)), JStore(9, (6, 8))
    for s in (store, jstore):
        s.write_batch(idx, depth, conf, intri)
    for got, want in zip(store.fetch_many([7, 3]), jstore.fetch_many([7, 3])):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(store.fetch(5), jstore.fetch(5)):
        np.testing.assert_array_equal(got, want)
    got = store.scales_batch([3, 0, 7], [0, 5, 3])
    want = jstore.scales_batch([3, 0, 7], [0, 5, 3])
    for g, w in zip(got, want):
        assert np.isfinite(g).all() and np.isfinite(w).all()
        np.testing.assert_allclose(g, w, rtol=1e-5)
    store.reset()
    assert not store.depth.any() and not store.intri.any()


def test_port_runs_without_jax_yaml_pil_or_opencv():
    """The port's slice in a fresh interpreter where yaml, PIL, cv2, jax and
    the JAX package cannot be imported (as on the GPU machine)."""
    script = textwrap.dedent(f"""
        import importlib.abc, sys
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("yaml", "PIL", "cv2", "jax",
                                          "jaxlib", "vista_slam_tpu"):
                    raise ModuleNotFoundError(name)
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {REPO!r}); sys.path.insert(0, {os.path.dirname(__file__)!r})
        from test_torch_slam import MODEL, SLAM, frames, trajectory
        import numpy as np
        from vista_slam_tpu_torch.cli.common import build_slam
        from vista_slam_tpu_torch.cli.run import run_sequence
        from vista_slam_tpu_torch.utils.config import make_config
        cfg = make_config(dict(SLAM, model=MODEL))
        slam = build_slam(cfg)
        run_sequence(slam, frames(), cfg, progress=False)
        assert slam.view_num == 5 and np.isfinite(trajectory(slam)).all()
        assert "jax" not in sys.modules, "the port imported jax"
        assert not any(m == "vista_slam_tpu" or m.startswith("vista_slam_tpu.")
                       for m in sys.modules), "the port imported the JAX package"
        print("NO_JAX_OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


def _imported_roots(path):
    """Top-level package names of every import statement in a source file
    (at any depth: module level, functions, try blocks)."""
    import ast

    roots = set()
    for node in ast.walk(ast.parse(open(path).read(), filename=path)):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_import_no_jax_or_jax_package():
    """No file of the port, and not chip_smoke.py, imports jax or the JAX
    package ``vista_slam_tpu`` (relative imports stay inside the port)."""
    pkg = os.path.join(REPO, "vista_slam_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    assert len(files) > 30
    bad = {os.path.relpath(f, REPO): sorted(r & {"jax", "jaxlib", "vista_slam_tpu"})
           for f in files for r in [_imported_roots(f)]
           if r & {"jax", "jaxlib", "vista_slam_tpu"}}
    assert not bad, bad


def test_bow_builds_at_first_use_and_matches_jax(monkeypatch):
    """The port's BoW vocabulary: importing it builds nothing; its C++
    helper (built with g++ at first use) and its numpy path give the JAX
    package's words and scores on a vocabulary trained from seeded
    descriptors (words exact, scores within 1e-6)."""
    code = ("import vista_slam_tpu_torch.native.bow as b, "
            "vista_slam_tpu_torch.native.bow_native as n; "
            "assert b._NATIVE is None and n._lib is None")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)

    from vista_slam_tpu.native import bow as jbow
    from vista_slam_tpu_torch.native import bow

    rng = np.random.default_rng(0)
    desc = rng.integers(0, 256, (300, 32), dtype=np.uint8)
    image_ids = rng.integers(0, 6, 300)
    vocab = bow.train_vocabulary(desc, k=4, levels=3, image_ids=image_ids)
    jvocab = jbow.train_vocabulary(desc, k=4, levels=3, image_ids=image_ids)
    queries = [rng.integers(0, 256, (40, 32), dtype=np.uint8) for _ in range(2)]
    jwords = [jvocab.descend(q) for q in queries]
    jvecs = [jvocab.transform(q) for q in queries]
    for native in (True, False):
        monkeypatch.setattr(bow, "_NATIVE", native)
        for q, w in zip(queries, jwords):
            np.testing.assert_array_equal(vocab.descend(q), w)
        a, b = (vocab.transform(q) for q in queries)
        assert vocab.score(a, b) == pytest.approx(jvocab.score(*jvecs), abs=1e-6)


def test_cli_main_end_to_end(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from vista_slam_tpu_torch.cli.run import main

    for k, f in enumerate(frames(6)):
        cv2.imwrite(str(tmp_path / f"frame_{k:03d}.png"),
                    cv2.cvtColor(((f["rgb"] + 1) * 127.5).astype(np.uint8),
                                 cv2.COLOR_RGB2BGR))
    out_dir = tmp_path / "out"
    cfg = tmp_path / "cfg.yaml"
    model = "\n".join(f"  {k}: {v}" for k, v in MODEL.items())
    cfg.write_text("\n".join(f"{k}: {v}" for k, v in SLAM.items())
                   + f"\noutput_dir: {out_dir}\nmodel:\n{model}\n")
    slam = main(["--config", str(cfg), "--images", str(tmp_path / "frame_*.png")])
    assert slam.view_num == 5
    traj = np.load(out_dir / "trajectory.npy")
    assert traj.shape == (5, 4, 4) and np.isfinite(traj).all()
    for name in ("depths.npy", "intrinsics.npy", "pointcloud.ply", "view_graph.npz"):
        assert (out_dir / name).exists()


def test_chip_smoke_settings_are_highres_yaml():
    import yaml

    import chip_smoke

    with open(os.path.join(REPO, "configs", "highres.yaml")) as f:
        want = yaml.safe_load(f)
    for k, v in chip_smoke.HIGHRES.items():
        assert want[k] == v, k
    assert set(want["model"]) == set(chip_smoke.HIGHRES["model"])


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_a_gpu_or_the_port(tmp_path, alone):
    """No CUDA device (this machine) or no port beside the script: a
    non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the script would run for real")
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
