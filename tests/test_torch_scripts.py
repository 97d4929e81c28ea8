"""The port's user scripts (vista_slam_tpu_torch/scripts/) on the CPU at tiny
sizes (the learning proof's bf16 step at its own small size), held against the JAX package's scripts/ where they compute the same
thing: the learning proof's pose-error probe, its .npz and its bf16 step,
adapt_gelu's drift and first distillation losses (and a NaN reported as NaN),
train_vocab's words; the loop-closure demo and the long-run stress with its
resume check; the loop detector's need for OpenCV; and the scripts in a
process where jax, the JAX package, OpenCV and matplotlib cannot load."""

import dataclasses
import glob
import importlib.util
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vista_slam_tpu.models.convert import load_params_npz as jax_load_params_npz
from vista_slam_tpu.models.convert import save_params_npz as jax_save_params_npz
from vista_slam_tpu.models.sta import STA as JSTA
from vista_slam_tpu.models.sta import STAConfig as JSTAConfig
from vista_slam_tpu_torch.datasets.synthetic_scene import SyntheticSceneDataset
from vista_slam_tpu_torch.models.convert import load_params_npz, state_dict_from_jax
from vista_slam_tpu_torch.models.sta import STA, STAConfig
from vista_slam_tpu_torch.scripts import (adapt_gelu, demo_loop_closure, stress_long_run,
                                          train_synthetic, train_vocab)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one tiny model for every case: 64 tokens, the linear pointmap head
TINY = dict(img_size=(64, 64), patch_size=8, enc_dim=32, enc_depth=1, enc_heads=1,
            dec_dim=32, dec_depth=2, dec_heads=1, mlp_ratio=2, head_type="linear")
PORT_CFG = STAConfig(**TINY, compute_dtype=torch.float32, param_dtype=torch.float32)
JAX_CFG = JSTAConfig(**TINY, compute_dtype=jnp.float32)
KEYS = ("pts3d", "conf", "pose", "pose_conf")
JAX_APPLY = jax.jit(JSTA(JAX_CFG).apply)  # compiled once, for batches of 2 pairs


def _jax_script(name):
    """A script of the JAX package's scripts/ directory, imported by path."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_params():
    """The JAX package's init of the tiny model (numpy leaves)."""
    d = jnp.zeros((1, 64, 64, 3))
    return jax.device_get(jax.jit(JSTA(JAX_CFG).init)(jax.random.PRNGKey(0), d, d))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train_synthetic.main on the tiny model: 3 steps of batch 2 at a small
    lr (at 3 steps the schedule's warm-up is a single step), no evaluation."""
    out = tmp_path_factory.mktemp("proof")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_synthetic, "CONFIG", PORT_CFG)
        res = train_synthetic.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                                    "--lr", "1e-5", "--skip-eval", "--out",
                                    str(out / "w.npz"), "--save-losses", str(out / "l.npy")])
    return str(out / "w.npz"), str(out / "l.npy"), res


def test_eval_pair_pose_error_matches_jax(jax_params):
    """The frontend's median rotation error on 4 held-out pairs, the same
    weights in both packages, fp32: within 1e-3 deg."""
    jts = _jax_script("train_synthetic")
    ds = SyntheticSceneDataset(**{**train_synthetic.DATASET, "radius": 1.6})
    got = train_synthetic.eval_pair_pose_error(PORT_CFG, state_dict_from_jax(jax_params),
                                               ds, n_pairs=4, device="cpu")
    want = jts.eval_pair_pose_error(JAX_CFG, jax_params, ds, n_pairs=4)
    assert np.isfinite(got) and np.isfinite(want) and got > 0
    assert abs(got - want) <= 1e-3, (got, want)


def test_learning_proof_weights_load_in_jax(trained):
    """main writes the JAX package's .npz: its load_params_npz + STA.apply
    give the port model's outputs (fp32) within 1e-4; the losses are the
    steps' and finite."""
    path, loss_path, res = trained
    losses = np.load(loss_path)
    assert losses.shape == (3,) and np.isfinite(losses).all()
    np.testing.assert_array_equal(losses, res["losses"])
    ds = SyntheticSceneDataset(**train_synthetic.DATASET)
    a = np.stack([ds.view(0)["img"], ds.view(5)["img"]])
    b = np.stack([ds.view(2)["img"], ds.view(6)["img"]])
    want = JAX_APPLY(jax_load_params_npz(path), a, b)
    model = STA(PORT_CFG)
    model.load_state_dict(state_dict_from_jax(load_params_npz(path)))
    with torch.no_grad():
        got = model(torch.as_tensor(a), torch.as_tensor(b))
    for k in KEYS:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert np.isfinite(g).all() and np.isfinite(w).all(), k
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_learning_proof_bf16_step_matches_jax():
    """The learning proof's step as it trains (train_synthetic.CONFIG: bf16
    compute, fp32 parameters, the DPT head) on the first batch of
    TrainLoader(ds, 1, 3), the same weights on both sides (the port's
    seeded init, converted; seed 0 draws a large confidence logit, as the
    proof's own init on the card does): the step-1 loss within two bf16
    roundings (rtol 2^-8) of the loss that the JAX package's make_train_step
    differentiates (make_loss_fn with its default reprojection VJP; 2.2e-3
    read, where bf16 moves the loss 5.6e-3 (JAX) and 7.8e-3 (port) from
    fp32's); the gradient no further from the fp32 gradient (the port's,
    held to the JAX package's in test_torch_train) than 1.5x the JAX
    package's own bf16 gradient is, over all leaves (1.20x read); and every
    leaf's gradient at a cosine of at least 0.99 to the JAX package's bf16
    one (0.998 read)."""
    from vista_slam_tpu.train.step import make_loss_fn as jax_make_loss_fn
    from vista_slam_tpu_torch.models.convert import convert_state_dict
    from vista_slam_tpu_torch.train.data import TrainLoader
    from vista_slam_tpu_torch.train.step import batch_to, make_loss_fn

    cfg = train_synthetic.CONFIG
    assert cfg.compute_dtype == torch.bfloat16 and cfg.head_type == "dpt"
    sd = STA(cfg).init_weights_(torch.Generator().manual_seed(0)).state_dict()
    loader = TrainLoader(SyntheticSceneDataset(**train_synthetic.DATASET), 1,
                         train_synthetic.N_SUPPORT)
    loader.set_epoch(0)
    batch = next(iter(loader))
    got = {}
    for dt in (torch.bfloat16, torch.float32):
        model = STA(dataclasses.replace(cfg, compute_dtype=dt))
        model.load_state_dict(sd)
        loss, _ = make_loss_fn(model.train(), train_synthetic.N_SUPPORT)(
            batch_to(batch, "cpu"))
        loss.backward()
        got[dt] = loss.item(), {k: p.grad.double() for k, p in model.named_parameters()
                                if p.grad is not None}
    jcfg = JSTAConfig(compute_dtype=jnp.bfloat16, **{
        f: getattr(cfg, f) for f in ("img_size", "patch_size", "enc_dim", "enc_depth",
                                     "enc_heads", "dec_dim", "dec_depth", "dec_heads",
                                     "mlp_ratio", "head_type")})
    jloss_fn = jax_make_loss_fn(JSTA(jcfg), train_synthetic.N_SUPPORT)
    (jloss, _), jgrad = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        convert_state_dict({k: v.numpy() for k, v in sd.items()}), batch)
    jgrad = {k: v.double() for k, v in state_dict_from_jax(jax.device_get(jgrad)).items()}

    (loss, grad), (_, exact) = got[torch.bfloat16], got[torch.float32]
    assert np.isfinite(loss) and abs(loss - float(jloss)) <= 2 ** -8 * abs(float(jloss))
    # the JAX package keeps k*k untied copies of a strided upsample's bias
    # where the port ties them: those leaves do not convert one to one
    keys = [k for k in exact if not k.endswith(("act_postprocess.0.1.bias",
                                                 "act_postprocess.1.1.bias"))]
    assert len(keys) > 150

    def dist(g):
        return (sum(float(((g[k] - exact[k]) ** 2).sum()) for k in keys)
                / sum(float((exact[k] ** 2).sum()) for k in keys)) ** 0.5

    assert np.isfinite(dist(grad)) and dist(grad) <= 1.5 * dist(jgrad), (dist(grad),
                                                                          dist(jgrad))
    cos = {k: float((grad[k] * jgrad[k]).sum() / (grad[k].norm() * jgrad[k].norm()))
           for k in keys}
    assert min(cos.values()) >= 0.99, min(cos.items(), key=lambda kv: kv[1])


def test_adapt_gelu_matches_jax(jax_params, tmp_path, monkeypatch):
    """The same JAX-initialised weights and pairs: the step-0 drift (erf
    teacher against tanh student) and the first 3 distillation losses under
    Adam at optax's defaults, against the computation written with the JAX
    package's STA and optax.adam, fp32 on both sides: the drift within rtol
    1e-3 and 1e-5 of the outputs' magnitude, the losses within rtol 5e-3."""
    npz = str(tmp_path / "p.npz")
    jax_save_params_npz(npz, jax_params)
    monkeypatch.setattr(adapt_gelu, "SMALL", dict(TINY, compute_dtype=torch.float32,
                                                  param_dtype=torch.float32))
    res = adapt_gelu.main(["--device", "cpu", "--params", npz, "--steps", "3",
                           "--eval-every", "3", "--batch", "2", "--n-train-pairs", "2",
                           "--n-eval-pairs", "2"])

    # the JAX script's pairs and images
    rng = np.random.default_rng(0)
    pairs = [(int(i), int((i + d) % 64)) for i, d in zip(rng.integers(0, 64, 4),
                                                         rng.integers(1, 4, 4))]
    assert adapt_gelu.split_pairs(0, 2, 2) == (pairs[:2], pairs[2:])
    jag = _jax_script("adapt_gelu")
    ds = SyntheticSceneDataset(n_frames=64, hw=(64, 64), focal=48.0, radius=2.0)
    train = jag.make_pairs(ds, pairs[:2])
    held = [jag.make_pairs(ds, pairs[2:4])]
    student = JSTA(dataclasses.replace(JAX_CFG, gelu_approx=True))
    t_train = JAX_APPLY(jax_params, *train)  # the erf teacher
    t_held = [JAX_APPLY(jax_params, a, b) for a, b in held]

    def loss_fn(p, a, b, t):
        out = student.apply(p, a, b)
        return sum(jnp.mean((out[k] - t[k]) ** 2) for k in KEYS), out

    # one compile: the student's outputs on the held-out pairs come as aux
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    s_held = step(jax_params, *held[0], t_held[0])[0][1]
    m0 = {k: np.abs(np.asarray(s_held[k], np.float64)
                    - np.asarray(t_held[0][k], np.float64)).max() for k in KEYS}
    got = res["drifts"][0][0]
    for k in KEYS:
        # a drift is a difference of two fp32 outputs: it also carries their
        # rounding, ~1e-6 of the output's magnitude
        scale = np.abs(np.asarray(t_held[0][k])).max()
        assert np.isfinite(got[k]) and np.isfinite(m0[k]) and m0[k] > 0, k
        np.testing.assert_allclose(got[k], m0[k], rtol=1e-3, atol=1e-5 * scale, err_msg=k)

    tx = optax.adam(3e-5)

    @jax.jit
    def update(p, o, g):
        up, o = tx.update(g, o, p)
        return optax.apply_updates(p, up), o

    p, o = jax_params, jax.jit(tx.init)(jax_params)
    want = []
    for _ in range(3):  # one training batch, taken 3 times
        (loss, _), g = step(p, *train, t_train)
        p, o = update(p, o, g)
        want.append(float(loss))
    # the loss is an MSE of differences ~1e-3 of the outputs, so the
    # outputs' fp32 rounding enters it at ~1e-4; and Adam moves each weight
    # by about lr whatever its gradient's size, so a gradient at rounding
    # level that changes sign between the packages moves a weight the
    # other way: rtol 5e-3
    assert np.isfinite(res["losses"]).all() and np.isfinite(want).all()
    np.testing.assert_allclose(res["losses"], want, rtol=5e-3)


def test_adapt_gelu_reports_a_nan_drift_as_nan(monkeypatch, capsys):
    """A NaN planted in the student's pointmaps gives a NaN drift (the JAX
    script's max(0.0, nan) gave 0.0) and never the WITHIN verdict."""
    class NanStudent(STA):
        def forward(self, img1, img2):
            out = super().forward(img1, img2)
            if self.cfg.gelu_approx:
                out["pts3d"] = out["pts3d"].clone()
                out["pts3d"].view(-1)[0] = float("nan")
            return out

    monkeypatch.setattr(adapt_gelu, "SMALL", dict(TINY, compute_dtype=torch.float32,
                                                  param_dtype=torch.float32))
    monkeypatch.setattr(adapt_gelu, "STA", NanStudent)
    res = adapt_gelu.main(["--device", "cpu", "--steps", "1", "--eval-every", "1",
                           "--batch", "2", "--n-train-pairs", "2", "--n-eval-pairs", "2"])
    out = capsys.readouterr().out
    m, r = res["drifts"][0]
    assert np.isnan(m["pts3d"]) and np.isnan(r["pts3d"]) and np.isfinite(m["pose"])
    assert not adapt_gelu.within(m)
    assert "WITHIN" not in out and res["k_ok"] is None
    assert "NOT within" in res["verdict"]


def test_train_vocab_matches_jax(tmp_path):
    """ORB over a glob of written images, then the vocabulary: the same
    tree, words and weights as the JAX package's train_vocabulary on the
    same descriptors, as .npz and as DBoW3 text."""
    from test_bow import make_textured_image
    from vista_slam_tpu.native.bow import Vocabulary as JVocabulary
    from vista_slam_tpu.native.bow import train_vocabulary as jax_train_vocabulary
    from vista_slam_tpu_torch.native.bow import Vocabulary

    for i in range(6):
        cv2.imwrite(str(tmp_path / f"im{i}.png"), make_textured_image(i))
    pattern = str(tmp_path / "*.png")
    got = train_vocab.main(["--images", pattern, "--out", str(tmp_path / "v.npz"),
                            "--k", "4", "--levels", "3"])
    orb = cv2.ORB_create()
    descs, ids = [], []
    for i, p in enumerate(sorted(glob.glob(pattern))):
        _, d = orb.detectAndCompute(cv2.imread(p, cv2.IMREAD_GRAYSCALE), None)
        descs.append(d)
        ids.append(np.full(len(d), i))
    want = jax_train_vocabulary(np.concatenate(descs), k=4, levels=3, seed=0,
                                image_ids=np.concatenate(ids), n_images=6)
    loaded = Vocabulary().load(str(tmp_path / "v.npz"))
    assert want.num_words > 8
    for v in (got, loaded):
        assert v.num_words == want.num_words
        for name in ("child_idx", "child_desc", "node_word", "node_weight"):
            np.testing.assert_array_equal(getattr(v, name), getattr(want, name), err_msg=name)
    train_vocab.main(["--images", pattern, "--out", str(tmp_path / "v.txt"),
                      "--k", "4", "--levels", "3"])
    text = JVocabulary().load(str(tmp_path / "v.txt"))
    assert text.num_words == want.num_words
    np.testing.assert_array_equal(text.node_word, want.node_word)


def test_demo_loop_closure_finds_the_revisit(trained, monkeypatch):
    """Two revolutions with the tiny trained weights: a finite trajectory of
    48 keyframes and loop edges from the second revolution to the first."""
    monkeypatch.setattr(demo_loop_closure, "CONFIG", PORT_CFG)
    res = demo_loop_closure.main([trained[0], "--device", "cpu"])
    traj = res["trajectory"]
    assert traj.shape == (48, 4, 4) and np.isfinite(traj).all()
    assert any(max(v, u) >= demo_loop_closure.REV > min(v, u) for v, u in res["loops"]), \
        f"no loop edge from the second revolution to the first: {res['loops']}"
    assert np.isfinite([res["ate_loop"], res["ate_noloop"]]).all()


def test_stress_long_run_resumes_bit_identical(tmp_path, monkeypatch):
    """24 keyframes of the revisiting strip at 224x224 on a tiny model, the
    state saved at keyframe 12 and a fresh OnlineSLAM resumed from it: a
    finite trajectory, the artifacts written, the resume bit-identical (at
    24 keyframes loop_dist_min 40 admits no loop)."""
    monkeypatch.setattr(stress_long_run, "CONFIG", STAConfig(
        img_size=(224, 224), patch_size=32, enc_dim=64, enc_depth=1, enc_heads=1,
        dec_dim=64, dec_depth=2, dec_heads=1, mlp_ratio=2, head_type="linear",
        compute_dtype=torch.float32))
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    out = tmp_path / "out"
    res = stress_long_run.main(["--device", "cpu", "--keyframes", "24", "--save-resume-at",
                                "12", "--print-every", "12", "--out", str(out)])
    assert res["trajectory"].shape == (24, 4, 4) and np.isfinite(res["trajectory"]).all()
    assert res["resume_identical"] is True and res["loop_edges"] == 0
    assert os.path.exists(out / "trajectory.npy") and os.path.exists(tmp_path / "stress_state.npz")


def test_loop_detector_needs_opencv_and_says_so(monkeypatch):
    """Without cv2 the detector raises an error naming OpenCV (it used to
    find no loop, silently); with no vocabulary configured the CLI still
    builds none."""
    from vista_slam_tpu_torch.cli.common import build_loop_detector
    from vista_slam_tpu_torch.native.bow import train_vocabulary
    from vista_slam_tpu_torch.slam import loop_detector
    from vista_slam_tpu_torch.utils.config import make_config

    vocab = train_vocabulary(np.random.default_rng(0).integers(0, 256, (64, 32), np.uint8),
                             k=2, levels=2)
    assert loop_detector.LoopDetector(vocab).orb is not None
    monkeypatch.setattr(loop_detector, "cv2", None)
    with pytest.raises(ModuleNotFoundError, match="OpenCV"):
        loop_detector.LoopDetector(vocab)
    assert build_loop_detector(make_config({})) is None


def test_scripts_run_without_jax_opencv_or_matplotlib(tmp_path):
    """Every script module imports in a process where jax, the JAX package,
    OpenCV, matplotlib, yaml and PIL cannot load; the learning proof trains
    there, the scripts that need OpenCV or matplotlib raise an error naming
    it, and --device cuda without a card raises instead of taking the CPU."""
    script = textwrap.dedent(f"""
        import importlib, importlib.abc, sys
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "vista_slam_tpu", "cv2",
                                          "matplotlib", "yaml", "PIL"):
                    raise ModuleNotFoundError(name)
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {REPO!r})
        import numpy as np, torch
        names = ["train_synthetic", "adapt_gelu", "train_vocab", "demo_loop_closure",
                 "stress_long_run", "vis_slam_results", "vis_ply", "render_flythrough",
                 "extract_images", "plot_train_log"]
        mods = {{n: importlib.import_module("vista_slam_tpu_torch.scripts." + n)
                for n in names}}
        from vista_slam_tpu_torch.models.sta import STAConfig
        ts = mods["train_synthetic"]
        ts.CONFIG = STAConfig(img_size=(64, 64), patch_size=8, enc_dim=32, enc_depth=1,
                              enc_heads=1, dec_dim=32, dec_depth=2, dec_heads=1,
                              mlp_ratio=2, head_type="linear", compute_dtype=torch.float32)
        res = ts.main(["--device", "cpu", "--steps", "2", "--batch", "1", "--lr", "1e-5",
                       "--skip-eval", "--out", {str(tmp_path / "w.npz")!r}])
        assert np.isfinite(res["losses"]).all()
        for name, argv, needs in (("train_vocab", ["--images", "x", "--out", "y"], "OpenCV"),
                                  ("demo_loop_closure", ["--device", "cpu"], "OpenCV"),
                                  ("stress_long_run", ["--device", "cpu"], "OpenCV"),
                                  ("render_flythrough", ["--result-dir", "x"], "OpenCV"),
                                  ("extract_images", ["--result-dir", "x"], "OpenCV"),
                                  ("vis_slam_results", ["--result-dir", "x"], "matplotlib"),
                                  ("vis_ply", ["--ply", "x"], "matplotlib"),
                                  ("plot_train_log", ["--log", "x"], "matplotlib")):
            try:
                mods[name].main(argv)
            except ModuleNotFoundError as e:
                assert needs in str(e), (name, e)
            else:
                raise AssertionError(name + " ran without " + needs)
        if not torch.cuda.is_available():
            try:
                ts.main(["--steps", "1"])
            except RuntimeError as e:
                assert "--device cpu" in str(e)
            else:
                raise AssertionError("--device cuda ran without a card")
        assert "jax" not in sys.modules and "cv2" not in sys.modules
        assert not any(m == "vista_slam_tpu" or m.startswith("vista_slam_tpu.")
                       for m in sys.modules)
        print("SCRIPTS_NO_JAX_OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SCRIPTS_NO_JAX_OK" in proc.stdout
