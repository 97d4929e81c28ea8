"""The PyTorch port's training slice against the JAX package, on the CPU.

Same inputs on both sides (numpy from a seed): losses, the train forward,
the loss and every gradient, optimizer steps, the lr schedule, the weight
decay mask and the loader's batches. The JAX side runs its Pallas kernels
in interpret mode, as tests/test_flash.py runs them; the port's CPU tensors
take the kernels' plain versions. Model: 32x32 images, patch 4 (64 tokens
plus the pose token), head dim 64, flash attention, fp32 compute; its DPT
and trunk leaves leave several tensors eligible for the fused optimizer.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_model import random_state_dict
from vista_slam_tpu.models.convert import convert_state_dict
from vista_slam_tpu.models.sta import STA as JSTA
from vista_slam_tpu.models.sta import STAConfig as JSTAConfig
from vista_slam_tpu_torch.models.convert import jax_param_ndims, state_dict_from_jax
from vista_slam_tpu_torch.models.sta import STA, STAConfig
from vista_slam_tpu_torch.train import losses, step
from vista_slam_tpu_torch.train.quantized_opt import FusedBf16Leaf
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TINY = dict(img_size=(32, 32), patch_size=4, enc_dim=64, enc_depth=1, enc_heads=1,
            dec_dim=64, dec_depth=2, dec_heads=1, mlp_ratio=2, use_flash=True,
            gelu_approx=True)
S, B = 3, 2  # neighbor_num 1 (two neighbours) + loop_num 1; batch 2
# the reference layout ties a strided upsample's bias across its k*k taps
# (the JAX package keeps k*k untied copies): such a gradient is the sum
# over the JAX copies
TIED_BIAS = {"downstream_head_pts.dpt.act_postprocess.0.1.bias": ("act0_up", 4),
             "downstream_head_pts.dpt.act_postprocess.1.1.bias": ("act1_up", 2)}


def _finite(*arrays):
    for a in arrays:
        assert np.isfinite(np.asarray(a)).all()


def _normwise(got, want):
    """max |got - want| over max |want| (NaN propagates)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _dataset(mod, **kw):
    return mod.SyntheticSceneDataset(n_frames=16, hw=(32, 32), focal=24.0, **kw)


@pytest.fixture(scope="module")
def batch():
    from vista_slam_tpu_torch.datasets import synthetic_scene
    from vista_slam_tpu_torch.train.data import TrainLoader

    loader = TrainLoader(_dataset(synthetic_scene), B, S)
    loader.set_epoch(0)
    return next(iter(loader))


@pytest.fixture(scope="module")
def pair(batch):
    """The port's model, the JAX params of the same weights, and the JAX
    loss / gradients / train-forward outputs on ``batch``."""
    from jax.experimental.pallas import tpu as pltpu

    from vista_slam_tpu.train.step import make_loss_fn as jmake_loss_fn

    model = STA(STAConfig(compute_dtype=torch.float32, param_dtype=torch.float32, **TINY))
    sd = random_state_dict(model, np.random.default_rng(3))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    params = convert_state_dict(sd)
    jm = JSTA(JSTAConfig(compute_dtype=jnp.float32, **TINY))
    loss_fn = jmake_loss_fn(jm, S, reproj_grad="f32")

    def fwd_and_grad(p, b):
        out = jm.apply(p, b["main"]["img"], b["support_imgs"], method=JSTA.train_forward)
        (loss, details), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, b, 0.4)
        return out, loss, details, grads

    with pltpu.force_tpu_interpret_mode():
        jout = jax.device_get(jax.jit(fwd_and_grad)(params, batch))
    return model, sd, params, jout


def test_train_forward_matches_jax(pair, batch):
    model, _, _, (jout, _, _, _) = pair
    b = step.batch_to(batch, "cpu")
    with torch.no_grad():
        out = model.train_forward(b["main"]["img"], b["support_imgs"])
    assert out["pts3d"].shape == (2 * S * B, 32, 32, 3)
    # bars of tests/test_torch_model.py::test_sta_forward_matches_jax
    tol = {"pts3d": dict(atol=2e-3), "conf": dict(rtol=1e-3, atol=1e-3),
           "pose": dict(atol=2e-3), "pose_conf": dict(atol=1e-3)}
    for k, t in tol.items():
        _finite(out[k], jout[k])
        np.testing.assert_allclose(out[k].numpy(), jout[k], rtol=t.get("rtol", 0),
                                   atol=t["atol"], err_msg=k)


def test_loss_and_every_gradient_match_jax(pair, batch):
    """The loss terms within 1e-4 relative, every gradient within 2e-3
    normwise (fp32 both sides; the sums run in other orders through ~20
    layers, and the pose head's SVD backward amplifies rounding)."""
    model, _, _, (_, jloss, jdetails, jgrads) = pair
    model.zero_grad(set_to_none=True)
    loss, details = step.make_loss_fn(model, S)(step.batch_to(batch, "cpu"), 0.4)
    loss.backward()
    _finite(loss.item(), jloss)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-4)
    for k, v in details.items():
        np.testing.assert_allclose(v.item(), jdetails[k], rtol=1e-4, atol=1e-6, err_msg=k)

    want = state_dict_from_jax(jgrads)
    head = jgrads["params"]["head_pts"]
    for name, (src, k) in TIED_BIAS.items():
        want[name] = torch.from_numpy(head[src]["proj"]["bias"].reshape(k * k, -1).sum(0))
    n_checked = 0
    for name, p in model.named_parameters():
        if p.grad is None:  # the deepest fusion block's unused skip unit
            assert "refinenet4.resConfUnit1" in name and not want[name].any(), name
            continue
        got = p.grad.numpy()
        _finite(got, want[name])
        err = _normwise(got, want[name].numpy())
        assert err <= 2e-3, (name, err)
        n_checked += 1
    assert n_checked > 100


def test_criterion_terms_and_prediction_grads_match_jax(batch):
    """sta_criterion on the same predictions: every term within 1e-5
    relative and the gradient w.r.t. every prediction within 1e-4
    normwise (the JAX side with reproj_grad="f32", plain autograd of the
    gather on the port's)."""
    from vista_slam_tpu.train.losses import sta_criterion as jcrit

    rng = np.random.default_rng(5)
    n = S * B
    rot = np.linalg.qr(rng.standard_normal((2 * n, 3, 3)))[0]
    rot *= np.sign(np.linalg.det(rot))[:, None, None]
    pose = np.tile(np.eye(4, dtype=np.float32), (2 * n, 1, 1))
    pose[:, :3, :3] = 0.9 * np.eye(3) + 0.1 * rot
    pose[:, :3, 3] = 0.3 * rng.standard_normal((2 * n, 3))
    main_pts = np.concatenate([batch["main"]["pts3d_cam"]] * S)
    supp_pts = batch["supports"]["pts3d_cam"].reshape(n, 32, 32, 3)
    preds = {
        "pts3d": np.concatenate([main_pts, supp_pts])
        + 0.05 * rng.standard_normal((2 * n, 32, 32, 3)),
        "conf": 1 + rng.uniform(0.1, 2.0, (2 * n, 32, 32)),
        "pose": pose,
        "pose_conf": rng.uniform(0.05, 0.95, 2 * n)}
    preds = {k: np.asarray(v, np.float32) for k, v in preds.items()}

    def jloss(pr):
        mains, supps = _split_jax(pr)
        gts = [jax.tree_util.tree_map(lambda x, i=i: x[i], batch["supports"]) for i in range(S)]
        return jcrit(batch["main"], gts, mains, supps, conf_alpha=0.4, reproj_grad="f32")

    (jl, jd), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(preds)
    b = step.batch_to(batch, "cpu")
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in preds.items()}
    mains, supps = step.split_train_outputs(tp, S, B)
    gts = [{k: v[i] for k, v in b["supports"].items()} for i in range(S)]
    loss, details = losses.sta_criterion(b["main"], gts, mains, supps, conf_alpha=0.4)
    loss.backward()
    _finite(loss.item(), jl)
    assert float(jd["reproj_0"]) > 0  # the neighbour pairs have correspondences
    for k, v in details.items():
        np.testing.assert_allclose(v.item(), float(jd[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    for k in preds:
        _finite(tp[k].grad, jg[k])
        assert _normwise(tp[k].grad.numpy(), jg[k]) <= 1e-4, k


def _split_jax(pr):
    from vista_slam_tpu.train.step import split_train_outputs

    return split_train_outputs(pr, S, B)


def _opt_tree(rng):
    """A parameter set with leaves K5 takes (>= 2048 elements, a multiple
    of 1024) and leaves it does not, of rank 1, 2 and 4. The fused leaves
    hold 256 rows of 1024, one grid step of the JAX kernel (its interpret
    mode takes no ragged row block)."""
    shapes = {"w_big": (512, 512), "w_conv": (4, 4, 128, 128), "b_long": (262144,),
              "w_small": (8, 16), "bias": (16,)}
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("state_dtype", ["bf16_fused", "fp32"])
def test_optimizer_steps_match_jax(state_dtype):
    """3 steps with the same gradients: params within 1e-6 relative to
    their magnitude (fp32 arithmetic, other rounding of the global norm
    and of pow/cos), bf16 moments within one bf16 ulp of the moment's
    magnitude, fp32 moments within 1e-5. A bf16 moment one ulp apart (the
    fp32 value rounds the other way when the two clip coefficients differ
    in the last bit) moves that step's update u ~ 1 by up to 2^-7, so the
    fused leaves' params are held to 2e-4 absolute (lr 1e-2)."""
    from jax.experimental.pallas import tpu as pltpu

    from vista_slam_tpu.train.step import make_optimizer as jmake

    rng = np.random.default_rng(7)
    tree = _opt_tree(rng)
    grads = [{k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in tree.items()} for _ in range(3)]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, min_lr=1e-4,
              weight_decay=0.05, clip=1.0, state_dtype=state_dtype)

    tx = jmake(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    with pltpu.force_tpu_interpret_mode():
        js = tx.init(jp)
        for g in grads:
            if state_dtype == "bf16_fused":
                jp, js = tx.step(jp, g, js)
            else:
                import optax

                upd, js = tx.update(g, js, jp)
                jp = optax.apply_updates(jp, upd)
    jp = jax.device_get(jp)

    opt = step.make_optimizer(**kw)
    names = list(tree)
    params = [torch.from_numpy(tree[k].copy()).requires_grad_() for k in names]
    opt.init(params, [tree[k].ndim > 1 for k in names],
             [tuple(range(tree[k].ndim)) for k in names])
    for g in grads:
        for k, p in zip(names, params):
            p.grad = torch.from_numpy(g[k])
        opt.step()
    assert opt.count == 3
    fused = {k for k, m in zip(names, opt.moments) if isinstance(m, FusedBf16Leaf)}
    assert fused == ({"w_big", "w_conv", "b_long"} if state_dtype == "bf16_fused" else set())
    for k, p in zip(names, params):
        got = p.detach().numpy()
        _finite(got, jp[k])
        assert not np.array_equal(got, tree[k]), k  # moved by step 3
        if k in fused:
            np.testing.assert_allclose(got, jp[k], rtol=0, atol=2e-4, err_msg=k)
        else:
            assert _normwise(got, jp[k]) <= 1e-6, k

    if state_dtype == "bf16_fused":
        jm = js.moments
        for k, m in zip(names, opt.moments):
            for mine, theirs in ((m.mu, jm[k].mu), (m.nu, jm[k].nu)):
                mine = mine.float().numpy()
                theirs = np.asarray(jnp.asarray(theirs, jnp.float32))
                tol = 2 ** -8 if k in fused else 1e-5
                assert mine.shape == theirs.shape, k
                assert _normwise(mine, theirs) <= tol, k
    else:
        adam = js[1][0]
        for k, m in zip(names, opt.moments):
            assert _normwise(m.mu.numpy(), adam.mu[k]) <= 1e-5, k
            assert _normwise(m.nu.numpy(), adam.nu[k]) <= 1e-5, k


def test_schedule_matches_optax():
    """The port's float32 schedule against optax's at counts across the
    warm-up, its end, the cosine and past the end: within 1 ulp-ish (2e-7
    relative; numpy's and XLA's cos may round differently)."""
    import optax

    for lr, warm, total, end in ((1.5e-5, 10, 200, 1e-6), (1e-3, 3, 17, 0.0)):
        want = optax.warmup_cosine_decay_schedule(0.0, lr, warm, total, end)
        got = step.warmup_cosine_decay_schedule(0.0, lr, warm, total, end)
        for c in (0, 1, warm - 1, warm, warm + 1, (warm + total) // 2, total - 1,
                  total, total + 5):
            w = float(want(jnp.asarray(c, jnp.int32)))
            np.testing.assert_allclose(float(got(c)), w, rtol=2e-7, atol=1e-12,
                                       err_msg=f"count {c}")
    assert float(step.warmup_cosine_decay_schedule(0.0, 1.0, 5, 50)(0)) == 0.0
    # make_optimizer's warm-up clamp (train/step.py:44 of the JAX package)
    opt = step.make_optimizer(lr=1.0, warmup_steps=1000, total_steps=100,
                              state_dtype="fp32")
    np.testing.assert_allclose(float(opt.schedule(10)), 1.0, rtol=1e-7)


def test_decay_mask_matches_the_jax_tree():
    """jax_param_ndims(model) > 1 is exactly the set of leaves the JAX
    package decays (ndim > 1 in its own layout), mapped to the port's names
    through state_dict_from_jax."""
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    cfg = JSTAConfig(compute_dtype=jnp.float32, **TINY)
    shapes = jax.eval_shape(lambda: JSTA(cfg).init(jax.random.PRNGKey(0), dummy, dummy))
    marks = jax.tree_util.tree_map(
        lambda s: np.full(s.shape, 1.0 if len(s.shape) > 1 else 0.0, np.float32), shapes)
    want = {k: bool(v.any()) for k, v in state_dict_from_jax(marks).items()
            if "refinenet4.resConfUnit1" not in k}  # absent from a flax tree
    model = STA(STAConfig(compute_dtype=torch.float32, param_dtype=torch.float32, **TINY))
    ndims = jax_param_ndims(model)
    got = {k: ndims[k] > 1 for k in want}
    assert got == want
    assert set(ndims) == {k for k, _ in model.named_parameters()}
    assert any(not v for v in got.values()) and any(got.values())


def test_train_loader_batches_match_jax():
    from vista_slam_tpu.datasets import synthetic_scene as jscene
    from vista_slam_tpu.train.data import TrainLoader as JLoader
    from vista_slam_tpu_torch.datasets import synthetic_scene
    from vista_slam_tpu_torch.train.data import TrainLoader

    mine, theirs = TrainLoader(_dataset(synthetic_scene, seed=2), B, S), \
        JLoader(_dataset(jscene, seed=2), B, S)
    for loader in (mine, theirs):
        loader.set_epoch(1)
    assert len(mine) == len(theirs) == 8
    for k, (a, b) in enumerate(zip(mine, theirs)):
        flat_a = jax.tree_util.tree_leaves_with_path(a)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(b))
        assert len(flat_a) == len(flat_b) == 10
        for path, x in flat_a:
            np.testing.assert_array_equal(x, flat_b[path], err_msg=str(path))
        if k == 2:
            break


def test_chip_smoke_train_settings_are_train_fast_yaml():
    """The training slice chip_smoke.py drives (train/finetune.py) carries
    configs/train_fast.yaml's hyper-parameters and highres.yaml's model."""
    import os

    import yaml

    from vista_slam_tpu_torch.train import finetune

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "configs", "train_fast.yaml")) as f:
        want = yaml.safe_load(f)
    with open(os.path.join(repo, "configs", "highres.yaml")) as f:
        highres = yaml.safe_load(f)
    for k, v in finetune.TRAIN.items():
        assert want[k] == v, k
    assert finetune.SEED == highres["random_seed"]
    for k, v in finetune.MODEL.items():
        assert highres["model"][k] == (list(v) if isinstance(v, tuple) else v), k
    cfg = finetune.model_config()
    assert cfg.img_size == (384, 512) and cfg.use_flash and cfg.gelu_approx
    assert (cfg.enc_dim, cfg.enc_depth, cfg.dec_dim, cfg.dec_depth) == (1024, 24, 768, 12)
    assert cfg.compute_dtype == torch.bfloat16 and cfg.param_dtype == torch.float32
    assert finetune.n_support() == S
    opt = finetune.optimizer()
    # the peak lr after warmup_epochs of 32 steps (float32 schedule: rel 1e-6)
    assert opt.schedule(319) < opt.schedule(320) == pytest.approx(1.5e-5, rel=1e-6)


def test_train_step_runs_and_moves_params_on_cpu():
    """make_train_step with the fused optimizer on the CPU: a finite loss,
    finite gradients, K5's leaves on the fused path, params unchanged by
    step 1 (the warm-up lr is 0 at count 0) and moved by step 2. At 16x16
    and batch 1: the DPT head's convolutions dominate the CPU time."""
    from vista_slam_tpu_torch.datasets import synthetic_scene
    from vista_slam_tpu_torch.train.data import TrainLoader

    ds = synthetic_scene.SyntheticSceneDataset(n_frames=16, hw=(16, 16), focal=12.0)
    loader = TrainLoader(ds, 1, S)
    loader.set_epoch(0)
    batch = next(iter(loader))
    model = STA(STAConfig(compute_dtype=torch.float32, param_dtype=torch.float32,
                          **dict(TINY, img_size=(16, 16))))
    model.init_weights_(torch.Generator().manual_seed(0))
    opt = step.make_optimizer(lr=1e-4, warmup_steps=2, total_steps=20,
                              state_dtype="bf16_fused")
    step_fn = step.make_train_step(model, opt, S, device="cpu")
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    loss, details = step_fn(batch)
    assert np.isfinite(loss.item()) and set(details) == {
        f"{t}_{i}" for t in ("pts", "pose", "reproj") for i in range(S)}
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
    assert all(torch.equal(before[k], v) for k, v in model.named_parameters())
    loss2, _ = step_fn(batch)
    assert np.isfinite(loss2.item())
    moved = [k for k, v in model.named_parameters() if not torch.equal(before[k], v)]
    assert len(moved) > 100
    assert sum(isinstance(m, FusedBf16Leaf) for m in opt.moments) > 10
    never = lambda path: False  # noqa: E731
    for knob in (dict(accum_iter=2), dict(freeze=never)):
        opt = step.make_optimizer(**knob)  # the unfused modes take both
        assert getattr(opt, "every_k", 1) == knob.get("accum_iter", 1)
        assert opt.freeze is knob.get("freeze")
        with pytest.raises(ValueError, match="does not compose"):
            step.make_optimizer(state_dtype="int8_fused", **knob)
    for mode in ("int8_fused", "bf16_fused", "bf16", "int8"):
        assert step.make_optimizer(state_dtype=mode).state_dtype == mode


def test_training_after_an_inference_mode_forward():
    """RoPE tables cached by an inference-mode forward (SLAM) serve a later
    training backward at the same grid."""
    model = STA(STAConfig(compute_dtype=torch.float32, param_dtype=torch.float32,
                          **dict(TINY, img_size=(24, 40))))
    img = torch.rand(1, 24, 40, 3) * 2 - 1
    with torch.inference_mode():
        model(img, img)
    out = model(img, img)
    out["pts3d"].sum().backward()
    assert all(p.grad is not None for p in model.enc_blocks.parameters())
