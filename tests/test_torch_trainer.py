"""The port's training loop against the JAX package's, on the CPU.

Optimizer parity over 4 mini-steps with gradient accumulation (fp32, bf16
and int8 moments) and with the encoder frozen; ``remat``; the ``Trainer``
against the JAX ``Trainer`` from the same weights on the same ScanNet tree
(tests/test_train_data.py::scannet_root); the alpha schedule; checkpoint
resume bit for bit; the moment-dtype check; the non-finite-loss abort; and
``cli/train.py``. Model: 32x32 images, patch 16, encoder 32x1, decoder
32x4 (tests/test_trainer.py's), fp32 compute.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")

from test_train_data import scannet_root  # noqa: F401  (fixture reuse)
from vista_slam_tpu_torch.datasets.synthetic_scene import SyntheticSceneDataset
from vista_slam_tpu_torch.models.convert import state_dict_from_jax
from vista_slam_tpu_torch.models.sta import STA, STAConfig
from vista_slam_tpu_torch.train import step, trainer
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_size=(32, 32), patch_size=16, enc_dim=32, enc_depth=1, enc_heads=2,
            dec_dim=32, dec_depth=4, dec_heads=2, mlp_ratio=2)
# the reference layout's unused skip unit (no JAX leaf, no gradient), and
# the strided-upsample biases the JAX package keeps k*k untied copies of
UNUSED = "refinenet4.resConfUnit1"
TIED = ("act0_up", "act1_up")


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Remove each test's output directory when it ends: the tiny model's
    checkpoints take ~240 MB each (the DPT head's 19M parameters)."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _finite(*arrays):
    for a in arrays:
        assert np.isfinite(np.asarray(a, np.float64)).all()


@pytest.fixture(scope="module")
def weights():
    """Random reference-layout weights (numpy, seeded): the port's state
    dict and the JAX parameters of the same weights."""
    from test_torch_model import random_state_dict
    from vista_slam_tpu.models.convert import convert_state_dict

    sd = random_state_dict(_port_model(), np.random.default_rng(5))
    return {k: torch.from_numpy(v) for k, v in sd.items()}, convert_state_dict(sd)


def _port_model(sd=None, **kw):
    model = STA(STAConfig(compute_dtype=torch.float32, param_dtype=torch.float32,
                          **dict(TINY, **kw)))
    if sd is not None:
        model.load_state_dict(sd)
    return model


OPT = dict(lr=1e-2, warmup_steps=2, total_steps=20, min_lr=1e-4, weight_decay=0.05,
           clip=1.0)
# leaves of rank 1, 2 and 4, three of them with 2048+ elements (carried
# compressed by the bf16/int8 modes), one not a multiple of the 256-element
# int8 block
TREE = {"w_big": (64, 96), "w_conv": (3, 3, 16, 32), "b_long": (3000,),
        "w_small": (8, 16), "bias": (16,)}


def _jax_run(tx, params, grads):
    """The JAX optimizer over ``grads``: the parameters after each mini-step."""
    import optax

    @jax.jit
    def update(g, state, p):
        upd, state = tx.update(g, state, p)
        return optax.apply_updates(p, upd), state

    state, out = jax.jit(tx.init)(params), []
    for g in grads:
        params, state = update(g, state, params)
        out.append(jax.device_get(params))
    return out


def _assert_params_close(got, want, what):
    """Within 2e-4 (the bar of tests/test_torch_train.py::
    test_optimizer_steps_match_jax)."""
    _finite(got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4, err_msg=what)


@pytest.mark.parametrize("state_dtype", ["fp32", "bf16", "int8"])
def test_accum_iter_matches_jax_over_4_mini_steps(state_dtype):
    """make_optimizer(accum_iter=2) against the JAX package's
    (optax.MultiSteps) over 4 mini-steps from the same weights and
    gradients: every parameter close after each mini-step; the first
    mini-step of each pair leaves the parameters, the moments and the
    count alone."""
    from vista_slam_tpu.train.step import make_optimizer as jmake

    rng = np.random.default_rng(13)
    tree = {k: rng.standard_normal(s).astype(np.float32) for k, s in TREE.items()}
    grads = [{k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in tree.items()} for _ in range(4)]
    want = _jax_run(jmake(**OPT, accum_iter=2, state_dtype=state_dtype),
                    jax.tree_util.tree_map(jnp.asarray, tree), grads)

    opt = step.make_optimizer(**OPT, accum_iter=2, state_dtype=state_dtype)
    params = [torch.from_numpy(v.copy()).requires_grad_() for v in tree.values()]
    opt.init(params, [v.ndim > 1 for v in tree.values()],
             [tuple(range(v.ndim)) for v in tree.values()])
    for k, g in enumerate(grads):
        before = [p.detach().clone() for p in params]
        moments = [t.clone() for m in opt.moments for t in _tensors(m)]
        for p, name in zip(params, tree):
            p.grad = torch.from_numpy(g[name])
        opt.step()
        assert opt.count == (k + 1) // 2 and opt.mini_step == (k + 1) % 2
        if k % 2 == 0:
            assert all(torch.equal(p.detach(), b) for p, b in zip(params, before))
            assert all(torch.equal(t, b) for t, b in zip(
                [t for m in opt.moments for t in _tensors(m)], moments))
        for p, name in zip(params, tree):
            _assert_params_close(p.detach().numpy(), want[k][name],
                                 f"{name}, mini-step {k + 1}")
    assert all(not np.array_equal(p.detach().numpy(), tree[n]) for p, n in zip(params, tree))


def _tensors(leaf):
    return [leaf] if isinstance(leaf, torch.Tensor) else [t for x in leaf for t in _tensors(x)]


def test_freeze_encoder_matches_jax_over_4_steps(weights):
    """make_optimizer(freeze=freeze_encoder) bound to the tiny model against
    the JAX package's (optax.multi_transform) on the same weights and
    gradients: the frozen sets equal through models/convert.py's name map,
    every parameter within 2e-4 after each step, the frozen ones unchanged
    (and out of the clip's global norm on both sides)."""
    from vista_slam_tpu.train.step import freeze_encoder as jfreeze
    from vista_slam_tpu.train.step import make_optimizer as jmake

    sd, params = weights
    model = _port_model(sd)
    opt = step.make_optimizer(**OPT, freeze=step.freeze_encoder)
    step.bind_optimizer(model, opt)
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    marks = jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(x.shape, float(jfreeze(
            tuple(getattr(q, "key", str(q)) for q in path))), np.float32), params)
    assert frozen == {n for n, v in state_dict_from_jax(marks).items() if v.any()}
    assert {n.split(".")[0] for n in frozen} == {"patch_embed", "enc_blocks"}

    rng = np.random.default_rng(11)

    def grad(path, x):  # none for the JAX package's untied upsample biases
        names = [getattr(q, "key", str(q)) for q in path]
        if names[-1] == "bias" and any(t in names for t in TIED):
            return np.zeros_like(x)
        return (0.3 * rng.standard_normal(x.shape)).astype(np.float32)

    grads = [jax.tree_util.tree_map_with_path(grad, params) for _ in range(4)]
    want = _jax_run(jmake(**OPT, freeze=jfreeze), params, grads)
    for k, g in enumerate(grads):
        tg = state_dict_from_jax(g)
        for n, p in model.named_parameters():
            p.grad = tg[n].clone() if p.requires_grad and UNUSED not in n else None
        opt.step()
        w = state_dict_from_jax(want[k])
        for n, p in model.named_parameters():
            if UNUSED not in n:
                _assert_params_close(p.detach().numpy(), w[n], f"{n}, step {k + 1}")
    moved = {n for n, p in model.named_parameters() if not torch.equal(p.detach(), sd[n])}
    assert moved and not moved & frozen


@pytest.mark.parametrize("state_dtype", ["bf16_fused", "int8_fused"])
@pytest.mark.parametrize("what", ["accum_iter", "freeze"])
def test_fused_modes_refuse_accum_and_freeze_as_jax_does(state_dtype, what):
    from vista_slam_tpu.train.step import make_optimizer as jmake

    kw = {"accum_iter": 2} if what == "accum_iter" else {"freeze": step.freeze_encoder}
    with pytest.raises(ValueError) as theirs:
        jmake(state_dtype=state_dtype, **kw)
    with pytest.raises(ValueError) as mine:
        step.make_optimizer(state_dtype=state_dtype, **kw)
    assert str(mine.value) == str(theirs.value)


def _batch(n_frames=4, batch=2):
    from vista_slam_tpu_torch.train.data import TrainLoader

    loader = TrainLoader(SyntheticSceneDataset(n_frames=n_frames, hw=(32, 32), focal=24.0),
                         batch, 3)
    loader.set_epoch(0)
    return next(iter(loader))


def test_remat_gives_the_same_loss_and_gradients(weights):
    """remat=True: the port's loss and every gradient equal remat=False's
    exactly on the CPU, and its attention forwards run twice (the fused
    path's count doubles: 2 encoder calls and 4 decoder blocks of 2
    attentions). The loss against the JAX model with remat=True is in
    test_trainer_matches_jax (its step 1)."""
    from vista_slam_tpu_torch.ops import attention

    batch = step.batch_to(_batch(), "cpu")
    runs = {}
    for remat in (False, True):
        model = _port_model(weights[0], remat=remat, attn_fused_train=True)
        attention.CALLS.update(flash=0, plain=0, fused=0)
        loss, _ = step.make_loss_fn(model, 3)(batch)
        loss.backward()
        runs[remat] = (loss.detach(), {n: p.grad for n, p in model.named_parameters()
                                       if p.grad is not None}, attention.CALLS["fused"])
    (l0, g0, c0), (l1, g1, c1) = runs[False], runs[True]
    assert torch.isfinite(l0) and torch.equal(l0, l1)
    assert len(g0) > 100 and g0.keys() == g1.keys()
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    assert c0 == 2 * 1 + 2 * 4 and c1 == 2 * c0


def test_alpha_schedule_matches_jax():
    from vista_slam_tpu.train.trainer import TrainConfig as JConfig
    from vista_slam_tpu.train.trainer import _alpha_schedule as jalpha

    for kw in (dict(epochs=200), dict(epochs=7, alpha_init=0.3), dict(epochs=1),
               dict(epochs=10, alpha_c2f=False)):
        mine, theirs = trainer.TrainConfig(**kw), JConfig(**kw)
        for epoch in range(kw["epochs"] + 1):
            assert trainer._alpha_schedule(mine, epoch) == jalpha(theirs, epoch), (kw, epoch)


def test_train_config_matches_jax():
    from vista_slam_tpu.train.trainer import TrainConfig as JConfig

    mine = {f.name: f.default for f in dataclasses.fields(trainer.TrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JConfig)}
    assert mine == theirs and mine["opt_state_dtype"] == "bf16"
    assert trainer.TrainConfig(neighbor_num=2, loop_num=3).n_support == 7


def _spec(root, mult=4):
    data_root, vg_root = root
    return (f"{mult} @ ScanNet(sensor_data_root='{data_root}', "
            f"view_graph_root='{vg_root}', resolution=(32, 32), "
            f"neighbor_range=4, neighbor_num=1, loop_num=1, num_sample_per_scene=2)")


def _recording(fn, losses):
    def run(*args):
        out = fn(*args)
        losses.append(float(out[-2]))
        return out
    return run


def test_trainer_matches_jax(scannet_root, weights, tmp_path):  # noqa: F811
    """The port's Trainer and the JAX Trainer (one CPU device) from the same
    weights on the same tree, both with remat, 2 epochs of 2 steps with a
    test epoch each: per-step losses within 1e-4 relative at step 1 (the
    forward loss of the remat model at the shared weights) and 1e-3 after,
    the test losses within 1e-3, log.txt with the same keys per epoch, the
    same last and best checkpoint saves (the port's written to disk)."""
    from vista_slam_tpu.parallel.mesh import make_mesh
    from vista_slam_tpu.train.trainer import TrainConfig as JConfig
    from vista_slam_tpu.train.trainer import Trainer as JTrainer

    sd, params = weights
    kw = dict(train_dataset=_spec(scannet_root), test_dataset=_spec(scannet_root, 2),
              batch_size=2, epochs=2, warmup_epochs=1, opt_state_dtype="fp32")
    jt = JTrainer(JConfig(output_dir=str(tmp_path / "jax"),
                          model=dict(TINY, compute_dtype=jnp.float32, remat=True), **kw),
                  mesh=make_mesh(1, tp=1))
    jt.init_state(params=params, resume=False)
    jlosses, jsaves, saves = [], [], []
    jt.jit_step = _recording(jt.jit_step, jlosses)
    # the JAX package's orbax checkpoints are its own business: record the calls
    jt.save_checkpoint = lambda epoch, best, name="checkpoints": jsaves.append(
        (epoch, best, name))
    jt.fit()

    mt = trainer.Trainer(trainer.TrainConfig(
        output_dir=str(tmp_path / "port"), model=dict(TINY, compute_dtype="float32",
                                                      remat=True), **kw), device="cpu")
    assert mt.model_cfg.remat and mt.model_cfg.param_dtype == torch.float32
    mt.init_state(params=sd, resume=False)
    losses = []
    mt.step_fn = _recording(mt.step_fn, losses)
    save = mt.save_checkpoint
    mt.save_checkpoint = lambda epoch, best, name="checkpoints": saves.append(
        (epoch, best, name)) or save(epoch, best, name)
    mt.fit()

    assert len(losses) == len(jlosses) == 4 and mt.step == 4
    _finite(losses, jlosses)
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-4)
    np.testing.assert_allclose(losses[1:], jlosses[1:], rtol=1e-3)
    logs = [[json.loads(line) for line in open(tmp_path / d / "log.txt")]
            for d in ("port", "jax")]
    assert len(logs[0]) == len(logs[1]) == 2
    assert [set(e) for e in logs[0]] == [set(e) for e in logs[1]]
    for mine, theirs in zip(*logs):
        _finite(mine["test_loss"], theirs["test_loss"])
        np.testing.assert_allclose(mine["test_loss"], theirs["test_loss"], rtol=1e-3)
        assert mine["alpha"] == theirs["alpha"] and mine["steps"] == theirs["steps"] == 2
    assert [(e, n) for e, _, n in saves] == [(e, n) for e, _, n in jsaves]
    np.testing.assert_allclose([b for _, b, _ in saves], [b for _, b, _ in jsaves], rtol=1e-3)
    assert sorted(os.listdir(tmp_path / "port" / "checkpoints")) == ["0.pt", "1.pt"]
    assert os.listdir(tmp_path / "port" / "checkpoints_best")
    assert mt.best_epoch == jt.best_epoch


def _small_trainer(root, out, state_dtype):
    """A port Trainer over 2 view graphs of the ScanNet tree (one step an
    epoch, 2 epochs; sampled per (epoch, index), so a resumed run reads
    what an uninterrupted one reads), no test set."""
    cfg = trainer.TrainConfig(output_dir=str(out), train_dataset=_spec(root, 2),
                              batch_size=2, epochs=2, warmup_epochs=1,
                              opt_state_dtype=state_dtype,
                              model=dict(TINY, compute_dtype="float32"))
    return trainer.Trainer(cfg, device="cpu")


def _state(t):
    """Every parameter and optimizer tensor of a trainer, copied, with its count."""
    sd = t.optimizer.state_dict()
    return ([p.detach().clone() for p in t.model.parameters()],
            [x.clone() for leaf in sd["moments"] for x in leaf], sd["count"], t.step)


@pytest.mark.parametrize("state_dtype", ["fp32", "int8", "int8_fused"])
def test_resume_is_bit_identical(scannet_root, weights, tmp_path, state_dtype):  # noqa: F811
    """2 epochs of fit equal 1 epoch + save + a fresh trainer's resume + 1
    epoch bit for bit, parameters and optimizer state; the resumed
    int8_fused optimizer keeps the storage its kernel table points at."""
    full = _small_trainer(scannet_root, tmp_path / "full", state_dtype)
    full.init_state(params=weights[0], resume=False)
    full.fit()

    first = _small_trainer(scannet_root, tmp_path / "split", state_dtype)
    first.init_state(params=weights[0], resume=False)
    first.cfg = dataclasses.replace(first.cfg, epochs=1)  # stop after epoch 0
    first.fit()
    saved = _state(first)
    second = _small_trainer(scannet_root, tmp_path / "split", state_dtype)
    second.init_state(params=weights[0], resume=True)
    assert second.start_epoch == 1 and second.step == 1
    ptrs = [t.data_ptr() for m in second.optimizer.moments for t in _tensors(m)]
    for a, b in zip(_state(second)[:2], saved[:2]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert _state(second)[2:] == saved[2:]
    second.fit()
    assert ptrs == [t.data_ptr() for m in second.optimizer.moments for t in _tensors(m)] \
        or state_dtype != "int8_fused"
    got, want = _state(second), _state(full)
    assert got[2:] == want[2:] == (2, 2)
    for a, b in zip(got[:2], want[:2]):
        assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(p, weights[0][n]) for n, p in
                   zip((n for n, _ in second.model.named_parameters()), got[0]))


def test_resume_under_another_moment_dtype_raises(scannet_root, weights, tmp_path):  # noqa: F811
    saver = _small_trainer(scannet_root, tmp_path, "fp32")
    saver.init_state(params=weights[0], resume=False)
    saver.save_checkpoint(0, float("inf"))
    other = _small_trainer(scannet_root, tmp_path, "bf16")
    with pytest.raises(ValueError, match="'fp32'.*'bf16'"):
        other.init_state(params=weights[0], resume=True)


def test_non_finite_loss_aborts(scannet_root, weights, tmp_path):  # noqa: F811
    """A NaN batch -> FloatingPointError with the loss terms (reference:
    train.py:287-290)."""
    t = _small_trainer(scannet_root, tmp_path, "fp32")
    t.init_state(params=weights[0], resume=False)

    class Poisoned:
        def __init__(self, inner):
            self.inner = inner

        def set_epoch(self, e):
            self.inner.set_epoch(e)

        def __iter__(self):
            for b in self.inner:
                b["main"]["img"] = np.full_like(b["main"]["img"], np.nan)
                yield b

    t.loader = Poisoned(t.loader)
    with pytest.raises(FloatingPointError, match="non-finite loss at epoch 0 step 0"):
        t.train_one_epoch(0)


def test_train_cli_end_to_end(scannet_root, tmp_path):  # noqa: F811
    """cli/train.py: a YAML config -> TrainConfig -> Trainer.fit for one
    epoch on the CPU, and unknown keys refused up front."""
    import yaml

    from vista_slam_tpu_torch.cli.train import main

    raw = dict(train_dataset=_spec(scannet_root), output_dir=str(tmp_path / "out"),
               batch_size=2, epochs=1, warmup_epochs=1, opt_state_dtype="fp32",
               model=dict(TINY, img_size=[32, 32], compute_dtype="float32"))
    cfg = tmp_path / "train.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    t = main(["--config", str(cfg), "--device", "cpu"])
    assert t.step == 2 and t.device.type == "cpu"
    log = [json.loads(line) for line in open(tmp_path / "out" / "log.txt")]
    assert len(log) == 1 and np.isfinite(log[0]["loss"])
    assert os.path.exists(tmp_path / "out" / "checkpoints" / "0.pt")
    cfg.write_text(yaml.safe_dump(dict(raw, not_a_real_key=1)))
    with pytest.raises(SystemExit, match="unknown config keys"):
        main(["--config", str(cfg), "--device", "cpu"])


def test_trainer_runs_without_jax_yaml_pil_or_opencv(tmp_path):
    """The training path imports and runs where yaml, PIL, cv2, jax and the
    JAX package cannot be imported: Trainer.fit on a synthetic dataset,
    with a checkpoint saved and resumed."""
    script = textwrap.dedent(f"""
        import importlib.abc, sys
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("yaml", "PIL", "cv2", "jax",
                                          "jaxlib", "vista_slam_tpu"):
                    raise ModuleNotFoundError(name)
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {REPO!r})
        import torch
        torch.set_num_threads(1)
        from vista_slam_tpu_torch.cli import train  # noqa: F401
        from vista_slam_tpu_torch.datasets.synthetic_scene import SyntheticSceneDataset
        from vista_slam_tpu_torch.train.trainer import TrainConfig, Trainer
        cfg = TrainConfig(output_dir={str(tmp_path)!r}, batch_size=2, epochs=1,
                          warmup_epochs=1, model={TINY!r})
        for resume in (False, True):
            t = Trainer(cfg, device="cpu",
                        train_ds=SyntheticSceneDataset(n_frames=4, hw=(32, 32), focal=24.0))
            t.init_state(resume=resume)
            t.fit()
        assert t.start_epoch == 1 and t.step == 2
        assert "jax" not in sys.modules and "cv2" not in sys.modules
        print("NO_JAX_OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


def test_chip_smoke_trainer_settings_are_train_fast_yaml():
    """chip_smoke.py's trainer phase runs configs/train_fast.yaml's
    hyper-parameters and model section with the two memory knobs
    (attn_fused_train, int8_fused); only the dataset specs and the output
    directory are left out."""
    import yaml

    import chip_smoke

    with open(os.path.join(REPO, "configs", "train_fast.yaml")) as f:
        want = yaml.safe_load(f)
    got = chip_smoke.TRAINER
    assert set(want) - set(got) == {"train_dataset", "test_dataset", "output_dir"}
    assert set(got) <= set(want)
    for k, v in got.items():
        if k == "opt_state_dtype":
            assert (want[k], v) == ("bf16", "int8_fused")
        elif k == "model":
            assert v == dict(want[k], attn_fused_train=True)
        else:
            assert want[k] == v, k
    cfg = trainer.TrainConfig(**got)
    assert trainer.model_config(cfg.model).img_size == (224, 224)


def test_metrics_match_jax(tmp_path, monkeypatch):
    """SmoothedValue / MetricLogger give the JAX package's windowed and
    global statistics; ScalarWriter falls back to scalars.jsonl where
    torch.utils.tensorboard does not import."""
    from vista_slam_tpu.train import metrics as jmetrics
    from vista_slam_tpu_torch.train import metrics

    values = [1.0, 100.0, 2.0, 3.0, -4.5]
    mine, theirs = metrics.SmoothedValue(window_size=3), jmetrics.SmoothedValue(window_size=3)
    for v in values:
        mine.update(v)
        theirs.update(v)
        for k in ("median", "avg", "global_avg", "max", "value"):
            assert getattr(mine, k) == getattr(theirs, k), k
        assert str(mine) == str(theirs)
    mine.synchronize_between_processes()  # one process: nothing to reduce
    assert mine.global_avg == theirs.global_avg
    ml = metrics.MetricLogger(window_size=4)
    ml.update(loss=1.0, lr=0.1)
    ml.update(loss=2.0, lr=0.1)
    assert ml.loss.median == 1.5 and "loss" in ml.summary()

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    writer = metrics.ScalarWriter(str(tmp_path / "tb"))
    writer.add_scalar("train/loss_iter", 2.5, 7)
    writer.close()
    assert [json.loads(line) for line in open(tmp_path / "tb" / "scalars.jsonl")] == [
        {"tag": "train/loss_iter", "value": 2.5, "step": 7}]
    metrics.ScalarWriter(str(tmp_path / "off"), enabled=False).add_scalar("x", 1.0, 0)
    assert not (tmp_path / "off").exists()
